"""GPipe pipeline parallelism for ViT training across processes (port of
``vipers/parallel/pp.py``).

The encoder's L layers are split into S stages of L / S blocks, one
process a stage; the batch into M microbatches that go through the stages
one after another. The JAX package runs the schedule as one ``lax.scan``
of ticks inside ``shard_map``, hands activations on with ``ppermute`` and
gets the reverse pipeline from autodiff. Here each stage rank runs:

- forward, microbatch by microbatch: stage 0 embeds its rows (patch
  embedding, CLS, position, and the 128-multiple token pad where the
  training kernels engage), every stage runs its blocks (the port's
  ``EncoderBlock``, kernels on: rows 7-8 at 224, rows 1 and 12-13 at 384;
  the JAX stage's ``vit_block_forward`` is the einsum twin of the same
  function) and sends the activation to the next stage (``dist.send``);
  the last stage applies the final LayerNorm and head and the loss;
- backward, the microbatches in reverse: the last stage starts from the
  loss, every stage back-propagates through its blocks and sends the
  activation's cotangent to the one before (``dist.recv`` on the other
  side).

Every stage holds the embedding, final LayerNorm and head parameters too
("outer"); their gradients (stage 0's and stage S-1's) are summed over the
pipe group, so every stage takes the one-process update and holds the
same outer parameters, and a checkpoint needs only the blocks gathered.
With ``--pp-data D`` the (data, pipe) grid runs D pipelines, each on its
data rank's rows, and the gradients are then averaged over the data group.
``--pp-remat`` recomputes each block in the backward
(``torch.utils.checkpoint``). The pipelined eval step runs the same
forward. gloo moves CUDA tensors through pinned host memory
(``P2P_ROUTE``); NCCL and the CPU send them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from vipers_torch.parallel import mesh
from vipers_torch.parallel.tp import split_sq_norm

# how the last send/recv moved its tensor: "direct", or "host" (staged
# through pinned host memory: gloo with CUDA tensors)
P2P_ROUTE: dict = {}


def _host_staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(mesh.inner_group()) == "gloo"


def send(t: torch.Tensor, dst: int):
    """``t`` to global rank ``dst`` of the pipe group."""
    t = t.detach().contiguous()
    if _host_staged(t):
        P2P_ROUTE["send"] = "host"
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.send(host, dst, group=mesh.inner_group())
    else:
        P2P_ROUTE["send"] = "direct"
        dist.send(t, dst, group=mesh.inner_group())


def recv(shape, dtype, src: int, device) -> torch.Tensor:
    """A tensor from global rank ``src`` of the pipe group, on ``device``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if _host_staged(out):
        P2P_ROUTE["recv"] = "host"
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(host, src, group=mesh.inner_group())
        out.copy_(host)
    else:
        P2P_ROUTE["recv"] = "direct"
        dist.recv(out, src, group=mesh.inner_group())
    return out


def default_microbatch(n: int, stages: int, dd: int = 1) -> int:
    """JAX's default microbatch: the largest multiple of the data degree
    ``dd`` that divides the global batch ``n`` and is at most ``n //
    stages``."""
    if n % dd:
        raise ValueError(f"batch {n} not divisible by data-parallel degree {dd}")
    mb = max(dd, (n // stages) // dd * dd)
    while n % mb or mb % dd:
        mb -= dd
    return mb


def check_microbatch(n: int, mb: int, dd: int = 1):
    """JAX's divisibility errors for a given ``--pp-microbatch``."""
    if n % mb:
        raise ValueError(f"batch {n} not divisible by microbatch {mb}")
    if mb % dd:
        raise ValueError(f"microbatch {mb} not divisible by data-parallel degree {dd}")


def split_vit_params(sd: Dict[str, torch.Tensor], num_layers: int):
    """(outer, [block i's entries, keyed without the ``layers.i.`` prefix])
    of a ViT state dict (parameters, masks or momentum)."""
    outer = {k: v for k, v in sd.items() if not k.startswith("layers.")}
    blocks = [{} for _ in range(num_layers)]
    for k, v in sd.items():
        if k.startswith("layers."):
            i, rest = k[len("layers."):].split(".", 1)
            blocks[int(i)][rest] = v
    return outer, blocks


def check_pipeline(spec, cfg, world: int):
    """SystemExit for what the JAX driver refuses (its messages): a non-ViT,
    ``--model-ema``, dropout, layers that do not divide into the stages,
    ``--data-parallel`` or ``--model-parallel`` beside it, and a world that
    is not stages x ``--pp-data`` processes."""
    stages = cfg.pipeline_parallel
    if spec.family != "vit":
        raise SystemExit(f"--pipeline-parallel stages the ViT encoder; model {cfg.model!r} "
                         f"(family {spec.family!r}) is not supported")
    if cfg.model_ema:
        raise SystemExit("--pipeline-parallel does not support --model-ema")
    vcfg = spec.cfg
    if vcfg.dropout_rate or vcfg.attention_dropout_rate:
        raise SystemExit("--pipeline-parallel requires dropout 0 (no rng plumbing "
                         "through the pipelined schedule)")
    if vcfg.num_layers % stages:
        raise SystemExit(f"{vcfg.num_layers} encoder layers do not divide into "
                         f"{stages} pipeline stages")
    if cfg.data_parallel or cfg.model_parallel > 1:
        raise SystemExit("--data-parallel/--model-parallel cannot combine with "
                         "--pipeline-parallel; use --pp-data for DP x PP")
    pp_data = max(cfg.pp_data, 1)
    need = stages * pp_data
    if world != need:
        raise SystemExit(f"--pipeline-parallel {stages}"
                         + (f" --pp-data {pp_data}" if pp_data > 1 else "")
                         + f" needs {need} devices, have {world}")


class PipelineParallel:
    """Stage s of S's view of a ViT (``spec``, the whole model's):
    ``rank_spec`` builds its module (L / S blocks, named ``layers.0`` on),
    ``part`` cuts a whole state dict to the stage's (the outer entries and
    its blocks renamed), ``full`` assembles the whole one from every
    stage's part (a collective over the pipe group), ``sq_norm`` is the
    gradient clip's global norm."""

    axis = "pipe"

    def __init__(self, spec, group, s: int, stages: int, microbatch: int = 0,
                 remat: bool = False):
        self.spec, self.group, self.s, self.stages = spec, group, s, stages
        self.microbatch, self.remat = microbatch, remat
        self.num_layers = spec.cfg.num_layers
        self.per = self.num_layers // stages
        if self.num_layers % stages:
            raise ValueError(f"num_layers={self.num_layers} not divisible by {stages} "
                             "pipeline stages")
        self.rank_spec = spec.rebuild(dataclasses.replace(spec.cfg, num_layers=self.per))

    def wire(self, model):
        return model

    def part(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outer, blocks = split_vit_params(sd, self.num_layers)
        out = dict(outer)
        for i in range(self.per):
            out.update({f"layers.{i}.{k}": v for k, v in blocks[self.s * self.per + i].items()})
        return out

    def full(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outer, blocks = split_vit_params(sd, self.per)
        out = dict(outer)
        for i in range(self.per):
            for k, v in blocks[i].items():
                for s, part in enumerate(mesh.all_gather_tensor(v, group=self.group)):
                    out[f"layers.{s * self.per + i}.{k}"] = part
        return out

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        return split_sq_norm(grads, lambda k: k.startswith("layers."), self.group)


class _Call(torch.nn.Module):
    """``functional_call``'s way into one method of the stage's ViT."""

    def __init__(self, vit):
        super().__init__()
        self.vit = vit

    def forward(self, method: str, *args):
        return getattr(self.vit, method)(*args)


def _block_fn(block, names, token_mask):
    def run(h, *ws):
        return functional_call(block, dict(zip(names, ws)), (h,),
                               {"token_mask": token_mask, "need_attn": False})[0]

    return run


class _Stage:
    """One step's pass of this stage over its microbatches."""

    def __init__(self, pp: PipelineParallel, model, tensors: Dict[str, torch.Tensor],
                 compute_dtype, n_local: int, microbatch: Optional[int] = None):
        from vipers_torch.models.vit import _auto_seq_pad

        self.pp, self.model, self.tensors = pp, model, tensors
        self.first, self.last = pp.s == 0, pp.s == pp.stages - 1
        self.rank = mesh.rank()
        dd = mesh.data_world()
        n = n_local * dd
        mb = pp.microbatch if microbatch is None else microbatch
        mb = mb or default_microbatch(n, pp.stages, dd)
        check_microbatch(n, mb, dd)
        self.mb = mb // dd
        self.m = n_local // self.mb
        cfg = model.cfg
        self.seq_len = model.pos_embedding.shape[1]
        pad = _auto_seq_pad(self.seq_len, compute_dtype, model.training, False, cfg)
        self.t = -(-self.seq_len // pad) * pad if pad else self.seq_len
        self.dtype = compute_dtype
        self.call = _Call(model)
        self.outer = {"vit." + k: v for k, v in tensors.items() if not k.startswith("layers.")}
        self.blocks = []
        for i, block in enumerate(model.layers):
            names = [k for k, _ in block.named_parameters()]
            self.blocks.append((block, names, [tensors[f"layers.{i}.{k}"] for k in names]))

    def token_mask(self, device):
        if self.t == self.seq_len:
            return None
        valid = torch.arange(self.t, device=device) < self.seq_len
        return valid[None].expand(self.mb, self.t)

    def forward(self, images: Optional[torch.Tensor], i: int, device):
        """(this stage's input activation, its output: the next stage's
        input or, on the last stage, the logits)."""
        if self.first:
            x = images[i * self.mb:(i + 1) * self.mb].to(self.dtype)
            h = functional_call(self.call, self.outer, ("embed", x, None, None, False))[0]
            h_in = None
        else:
            h_in = recv((self.mb, self.t, self.model.cfg.hidden_dim), self.dtype,
                        self.rank - 1, device)
            h = h_in.requires_grad_(torch.is_grad_enabled())
        mask = self.token_mask(h.device)
        for block, names, ws in self.blocks:
            fn = _block_fn(block, names, mask)
            if self.pp.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(fn, h, *ws, use_reentrant=False)
            else:
                h = fn(h, *ws)
        if not self.last:
            send(h, self.rank + 1)
            return h_in, h
        return h_in, functional_call(self.call, self.outer, ("head_logits",
                                                             h[:, :self.seq_len]))[0]


def _pipe_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the pipe group (the last stage's metrics and
    the outer gradients to every stage)."""
    return mesh.all_reduce_(t, group=mesh.inner_group())


def make_pp_train_step(pp: PipelineParallel, num_classes: int, label_smoothing: float = 0.0,
                       compute_dtype=torch.float32):
    """``step(state, (images, labels)) -> (state, metrics)`` with
    ``train.steps.make_train_step``'s contract (masked gradients and
    updates, bf16 copies of the f32 masters under ``--amp``) for this
    stage's module: the GPipe forward and backward, the outer gradients
    summed over the stages, everything averaged over the data group, the
    optimizer. Metrics are the last stage's, on every stage."""
    from vipers_torch.train.steps import accuracy_topk, cross_entropy, forward_params

    def step(state, batch):
        images, labels = batch
        model = state.model
        model.train()
        params = dict(model.named_parameters())
        cast = forward_params(params, state.masks, compute_dtype)
        leaves = {k: v.detach().requires_grad_() for k, v in cast.items()}
        stage = _Stage(pp, model, leaves, compute_dtype, images.shape[0])
        n = images.shape[0]
        ins, outs, logits = [], [], []
        for i in range(stage.m):
            h_in, out = stage.forward(images, i, images.device)
            ins.append(h_in)
            if stage.last:
                rows = labels[i * stage.mb:(i + 1) * stage.mb]
                logits.append(out.detach())
                out = cross_entropy(out, rows, num_classes, label_smoothing) * (stage.mb / n)
            outs.append(out)
        loss = torch.zeros((), device=images.device)
        for i in reversed(range(stage.m)):
            if stage.last:
                loss = loss + outs[i].detach()
                torch.autograd.backward(outs[i])
            else:
                g = recv(outs[i].shape, outs[i].dtype, stage.rank + 1, images.device)
                torch.autograd.backward(outs[i], g)
            if not stage.first:
                send(ins[i].grad, stage.rank - 1)
            ins[i] = outs[i] = None
        grads_cast = [leaves[k].grad if leaves[k].grad is not None
                      else torch.zeros_like(leaves[k]) for k in cast]
        grads = dict(zip(params, torch.autograd.grad(list(cast.values()), list(params.values()),
                                                     grads_cast)))
        if stage.last:
            acc1, acc5 = accuracy_topk(torch.cat(logits), labels)
            metrics = torch.stack([loss.float(), acc1, acc5])
        else:
            metrics = torch.zeros(3, device=images.device)
        # the outer gradients (stage 0's embedding, stage S-1's head) and
        # the metrics to every stage in one reduce
        outer = [k for k in grads if not k.startswith("layers.")]
        flat = torch.cat([grads[k].reshape(-1) for k in outer] + [metrics])
        flat = _pipe_sum(flat)
        off = 0
        for k in outer:
            grads[k] = flat[off:off + grads[k].numel()].view_as(grads[k])
            off += grads[k].numel()
        loss, acc1, acc5 = flat[off:off + 3].unbind(0)
        grads, (loss, acc1, acc5) = mesh.average_gradients(grads, (loss, acc1, acc5))
        state.opt.step(grads, state.masks)
        state.step += 1
        return state, {"loss": loss, "acc1": acc1, "acc5": acc5}

    return step


@torch.no_grad()
def pp_vit_apply(pp: PipelineParallel, model, images: torch.Tensor,
                 tensors: Optional[Dict[str, torch.Tensor]] = None,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """The pipelined forward of this stage's ``model`` (eval mode) on NHWC
    ``images`` (this data rank's rows, in ``compute_dtype``) with
    ``tensors`` (default the module's own): the logits, on every stage of
    the pipe group. A batch that ``--pp-microbatch`` does not divide (the
    eval split's last) takes the default microbatch: the same function,
    where the JAX eval step raises."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    n = images.shape[0] * mesh.data_world()
    mb = pp.microbatch if pp.microbatch and n % pp.microbatch == 0 else 0
    was_training = model.training
    model.eval()
    try:
        stage = _Stage(pp, model, tensors, compute_dtype, images.shape[0], mb)
        logits = [stage.forward(images, i, images.device)[1] for i in range(stage.m)]
    finally:
        model.train(was_training)
    width = model.head.out_features if model.head is not None else model.cfg.hidden_dim
    out = (torch.cat(logits).float() if stage.last
           else torch.zeros((images.shape[0], width), device=images.device))
    return _pipe_sum(out)


def make_pp_eval_step(pp: PipelineParallel, num_classes: int, label_smoothing: float = 0.0,
                      compute_dtype=torch.float32):
    """The pipelined eval step, ``train.steps.make_eval_step``'s contract
    ({loss_sum, top1, top5, n} on every stage): a model that needs S
    stages to train does not fall back to one card's forward."""
    from vipers_torch.train.steps import eval_sums, forward_params

    @torch.no_grad()
    def step(state, batch):
        images, labels = batch
        tensors = forward_params(state.params, state.masks, compute_dtype)
        logits = pp_vit_apply(pp, state.model, images, tensors, compute_dtype)
        return eval_sums(logits, labels, num_classes, label_smoothing)

    return step
