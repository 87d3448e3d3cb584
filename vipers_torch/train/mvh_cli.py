"""``vipers_torch mvh`` (port of ``vipers/train/mvh_cli.py``): the
model-vs-human benchmarks of ``train.mvh`` on the train driver's session
(``build_session``): its model on ``--device``, its f32 or bf16 eval step,
its val split in order, the checkpoint's weights and masks when given."""

from __future__ import annotations

import itertools


def run_mvh_cli(args) -> int:
    import torch
    from torch.func import functional_call

    from vipers_torch.core.config import config_from_args
    from vipers_torch.models.cnn import exact_f32_convs
    from vipers_torch.train.driver import _val_loader, build_session
    from vipers_torch.train.mvh import eval_mvh, write_mvh_csv
    from vipers_torch.train.steps import forward_params, load_weights

    cfg = config_from_args(args)
    s = build_session(cfg, cmd="mvh")
    state = s.state
    state.model.eval()  # nothing trains here
    if args.checkpoint:
        from vipers_torch.discovery.driver import load_lost_checkpoint

        params, batch_stats, masks, _ = load_lost_checkpoint(args.checkpoint, s.spec)
        load_weights(state.model, state.family, params, batch_stats)
        if masks:
            state.masks = {k: m.to(s.device)
                           for k, m in state.family.masks_to_state_dict(masks).items()}

    def batches():
        # the val loader's host batches: the distortions run on them
        it = iter(_val_loader(s).loader)
        if args.max_batches:
            it = itertools.islice(it, args.max_batches)
        return it

    class _Reiterable:
        def __iter__(self):
            return batches()

    stimuli_root = getattr(args, "stimuli_root", None)
    stimuli_eval_fn = None
    if stimuli_root:
        from vipers_torch.train.mvh import make_stimuli_eval_fn

        @torch.no_grad()
        def logits_fn(x):
            tensors = {**forward_params(state.params, state.masks), **state.batch_stats}
            with exact_f32_convs():
                logits, _aux = functional_call(state.model, tensors, (x.to(s.device),),
                                               {"need_attn": False})
            return logits

        stimuli_eval_fn = make_stimuli_eval_fn(
            logits_fn, batch_size=cfg.batch_size, resize=cfg.val_resize_size,
            crop=cfg.val_crop_size, stimuli_root=stimuli_root)

    results = eval_mvh(s.eval_step, state, _Reiterable(), stimuli_root=stimuli_root,
                       stimuli_eval_fn=stimuli_eval_fn, device=s.device)
    path = write_mvh_csv(results, cfg.model, args.pruning_step, cfg.output_dir)
    print(f"wrote {path}")
    return 0
