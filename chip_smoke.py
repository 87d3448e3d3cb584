"""Quickest proof that the PyTorch/CUDA port (``vipers_torch``) runs on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions,
     both TF32 switches (cuBLAS matmuls, cuDNN convolutions);
  2. build: the six CUDA sources of ``vipers_torch/csrc``, one nvcc each,
     in parallel;
  3. kernels against their plain PyTorch versions at their main path's
     shapes (flash attention f32 and bf16, the flash backward f32 and bf16
     at the 384x384 train shape, packed token-major attention f32
     and bf16, fused LN->fc1->GELU bf16, the training attention forward and
     backward bf16 and their softmax-precision variants, every splash
     instance): max error against the stated tolerance (each variant also
     clearly nearer its own plain version than f32's), kernel / plain /
     library times (CUDA events, median), and the bound from the work's
     FLOPs and bytes; for the flash, flash backward, packed, fused-MLP and
     splash kernels also TFLOP/s and the share of the bound, and for flash
     and packed the attention tile's shape (bf16: query rows, key tile,
     stages; f32: query rows, key stage, raw and split stages, TF32
     products a product) and in f32 the shares of both the 3xTF32 and the
     FMA bounds (the kernels JSON's f32 bound is the 3xTF32 one); for the
     flash backward also the share of the bound of the seven products its
     split does and its design (tiles, stages, kernels), and in f32 the
     shares of both bounds and the error of the plain version under cuBLAS
     TF32, which the kernel must beat tenfold; for the fused MLP its design
     (rows a CTA, column tile, stages); for the training kernels the share
     of the bound and their design (tiles, chunk, stages); more checks the
     main path does not run: the training kernels at T = 640 (the two-pass
     forward and the backward's key rounds) and the fused MLP at vit_b's
     and vit_h's widths (D = 768 and 1280, F = 4D; timed, beside the
     library's sequence); then the ViT family's rows: the flash forward's
     hd-80 instances (f32 and bf16) at vit_h_14's LOST shape (B*H =
     128*16, T = 1024 with 1009 valid keys, bucket-pad keys on every other
     image, one image all invalid; SDPA with the bool mask as the library
     call) and the fused MLP at D = 768 and 1024 (M = 128*896) and 1280 (M
     = 128*1024); then vit_h_14's train rows at hd 80: the training
     forward and backward at its 224x224 shape (B*H = 32*16, T = 384 with
     257 valid keys) and the flash backward f32 and bf16 at its 392x392
     shape (B*H = 16*16, T = 896 with 785 valid keys, the last image
     attending no key);
  4. LOST path: full-width ViT-S/16 (12 layers, D=384, 6 heads, mlp 1536)
     from a seeded generator, 50% global magnitude mask, 512x384 uint8
     images, ``make_batched_pipeline`` in f32 and bf16 at B=128 on an
     exact-fit and a mixed-size bucket; the launch counters must show every
     block went through the kernels; B=4 against the same extractor on the
     CPU (plain versions); img/s at B=128 and p50 latency at B=1;
  5. packed LOST path: the same pipeline on the mixed-size bucket with
     ``VIPERS_PACKED_ATTENTION=1``: 12 packed and 0 flash launches per
     forward (and 12 fused MLP in bf16), f32 features within 2e-4 of the
     default route's scale with equal boxes; bf16 img/s and p50 of both
     routes on both buckets;
  6. JPEG -> boxes -> CorLoc: ``vipers_torch.cli.main lost`` in this
     process on a VOC07-layout tree of symlinks to the committed fixture
     (``tests/data/torch_voc``), with a full-width ViT-S/16 (seed 0, 50%
     global magnitude mask) written as a reference .pth in the
     weight_orig/weight_mask form, B=128, 8 decode threads: bf16 on 1024
     images, f32 on 256, bf16 on 256 under ``VIPERS_PACKED_ATTENTION=1``;
     preds.pkl one entry per image not reported as a seed-in-background
     failure, the results txt equal to ``corloc`` re-scoring, 12 attention
     and (bf16) 12 fused-MLP launches per batch, tail batches included, the
     first batch's boxes equal to ``make_batched_pipeline`` on the same
     decoded uint8 batch; e2e img/s (first decode to preds.pkl), the
     decode-only rate on 8 threads and on 1, the CPU count and the decoder
     (libjpeg or PIL). With
     neither libjpeg nor PIL on the host the phase says so and is skipped;
  7. train path: the masked bf16 train step of full-width ViT-S/16 at
     224x224 (T=197 seq-padded to 256), 1000 classes, SGD momentum with a
     cosine LR, uint8 images normalized on the card: 12 forward and 12
     backward launches of the training attention kernels per step, finite
     losses, pruned slots unchanged, img/s at B=128, card vs CPU at B=4,
     one LRR round;
  8. flash train path: the same step at 384x384 (T=577 seq-padded to 640,
     at least ``flash_min_t()``): 12 flash forward and 12 flash backward
     launches per step and none of the training kernels, finite losses,
     pruned slots unchanged, img/s at B=128, card vs CPU at B=2 (f32 params
     after 2 steps through the f32 flash kernels, counted; bf16 loss and
     gradients);
  9. the A/B tools at their shapes: ``vipers_torch.tools.bench_softmax_prec``
     (the softmax-precision variants), ``vipers_torch.tools.bench_splash``
     (the splash instances against the flash kernel) and
     ``vipers_torch.tools.bench_fused_mlp`` (the fused MLP against the
     layer_norm -> linear -> GELU sequence), their lines printed;
 10. ViT family LOST, full width, random weights from seed 0, pos tables
     at 224x224 interpolated to each bucket as ``vipers_torch lost`` does:
     ViT-B/16 (12 layers, D 768, 12 heads, mlp 3072; 50% global magnitude
     mask) at 512x384 in f32 and bf16 on an exact-fit and a mixed bucket
     (12 flash and 12 fused-MLP launches at D = 768 a bf16 batch), card vs
     CPU at B=2, img/s and p50; ``vipers_torch.cli.main lost --model
     vit_b_16 --patch-size 16 --dtype bf16`` from a pruned .pth on phase
     6's 1024 JPEGs (launches, first batch against the pipeline, the
     results txt against ``corloc``, e2e img/s); vit_b_32 bf16 at patch 32
     (T = 193: 0 flash, 12 fused-MLP launches a batch); vit_l_16 bf16 (24
     flash, 24 fused MLP at D = 1024); vit_h_14 (32 layers, D 1280, 16
     heads of 80) at 504x392 (T = 1009 -> 1024) in f32 and bf16 (32 hd-80
     flash launches a batch, 32 fused MLP at D = 1280 in bf16), bf16 img/s
     and p50, one f32 call's time, card vs CPU on its first 4 blocks at
     B=2 (the cut printed);
 11. vit_h_14 pruned and trained, full width and depth (32 blocks, D
     1280, 16 heads of 80, mlp 5120, 1000 classes, seed-0 weights, 50%
     global magnitude masks ranked on the card): phase 7's masked bf16
     step at 224x224 B=32 (T = 257 -> 384: 32 hd-80 training forward and
     backward launches a step, no flash, no fused MLP; img/s, peak device
     memory; one LRR round, 50% -> 60%) and phase 8's at 392x392 B=16 (T =
     785 -> 896: 32 hd-80 flash forward and backward a step), each card vs
     CPU on its first 2 blocks at B=2 (f32 params after 2 steps within
     1e-4, at 392 through the f32 hd-80 flash kernels, counted; bf16 loss
     and gradients); SNIP at 392 in f32: card vs CPU on the 4-block cut
     (masks at the target sparsity, equal up to threshold ties), then at
     full depth, B=8, on the card (32 f32 hd-80 flash forward and backward
     launches), then 2 bf16 steps from its masks;
 12. the pruning entry points through the CLI (``train_cli_phase``):
     ``vipers_torch.cli.main train --amp`` on ViT-B/16 at full width and
     depth (1000 classes, weights from the CLI's seed 42, 224x224, B=128, 8 decode
     threads) on an ImageFolder of 256 train and 256 val symlinks to the 8
     fixture JPEGs: SNIP to 50% for one epoch, then LRR (rate 0.2,
     threshold 36: two iterations of one epoch); ``evaluate --amp`` over
     the LRR checkpoints; ``lost`` from the iteration-01 checkpoint on 128
     JPEGs. Checks: the first train and val batches equal to the CPU
     loader's, 12 training-attention forward and backward launches a step
     and 12 fused-MLP launches (D = 768) an eval batch, no flash, finite
     bf16 losses, pruned slots zero in every LRR checkpoint and at their
     initial weights in the SNIP ones (unbaked), performance.txt's
     sparsities those of ``compute_sparsity_global`` on the checkpoints,
     evaluate's acc1 (f32 whatever --amp says, as the JAX sweep; no fused
     MLP launch) equal to the driver's own f32 eval of the same
     checkpoints, preds.pkl written; the
     f32 driver card vs CPU on vit_b_16 cut to 2 blocks at B=8 (SNIP's
     saliencies within 1e-5 of their scale, a TF32 run shown to miss it,
     masks; then from the card's masks 2 steps and one LRR iteration:
     parameters and masks). Prints train e2e, step, decode-only (8
     threads, 1) and evaluate img/s;
 13. the CNN families through the entry points (``cnn_phase``): ResNet-50
     at full width and depth (1000 classes, the CLI's seed-42 weights),
     ``train --amp`` at 224x224, B=128, 8 decode threads on phase 12's
     ImageFolder: SNIP to 50% for one epoch, LRR (rate 0.2, threshold 35.9:
     two iterations); ``evaluate --amp``; ``lost --arch resnet --model
     resnet50 --resnet-dilate 2 --dtype bf16`` from the iteration-01
     checkpoint and ``lost --arch vgg16 --model vgg16_bottom --dtype bf16``
     from a seed-0 .pth with a 50% global magnitude mask, on 256 of phase 6's
     JPEGs. Checks: no attention or fused-MLP launch in any CNN run (the
     counters set to 0 before each, read after), phase 12's checks of the
     batches, losses, checkpoints, performance.txt and evaluate, the LOST
     outputs against ``corloc`` and the first batch against
     ``make_batched_cnn_pipeline``; the CNN LOST pipeline f32 at B=4 card vs
     CPU on two bucket shapes (features within 1e-3 of their scale, boxes
     equal, tie-aware); the f32 driver on ResNet-50 at full depth, B=4, card
     vs CPU (SNIP's saliencies within 1e-5 of their scale; parameters and
     running statistics within 1e-4 after 2 steps and after one LRR
     iteration, the same run with cuDNN's TF32 convolutions printed beside
     it; bf16 loss within 2e-2 and gradients within 3e-2). Prints train e2e,
     step, decode-only and evaluate img/s, the CNN LOST pipeline's img/s at
     B=128 and p50, the CLIs' e2e img/s and the peak device memory;
 14. Swin-V2-T and the per-image LOST path (``swin_phase``): swin_v2_t at
     full width and depth (1000 classes, the CLI's seed-42 weights,
     stochastic depth 0.2) through ``train --amp`` at torchvision's recipe
     (256 crops, val resize 260, bicubic), B=128, on phase 12's ImageFolder:
     SNIP to 50%, LRR (rate 0.2, threshold 35.9: two iterations);
     ``evaluate --amp``; ``lost --arch swin --dtype bf16`` from the
     iteration-01 checkpoint on 64 JPEGs, first window and
     ``--swin-all-windows``; ``lost --arch resnet --exact-shapes`` on 32
     from phase 13's ResNet-50 .pth. Checks: no attention or fused-MLP
     launch in any run, phase 13's checks of batches, losses, checkpoints
     (no qkv or CPB kernel masked), performance.txt and evaluate (its acc1
     against the driver's f32 eval), the LOST outputs against ``corloc``,
     the first image against ``extract`` -> ``lost``; card vs CPU: the f32
     forward (B=2), the f32 driver at stochastic depth 0 (B=4: SNIP within
     1e-5 of the scale, parameters within 1e-4 after 2 steps and an LRR
     iteration, a TF32 run printed beside), bf16 loss 2e-2 and gradients
     3e-2, stochastic depth's keep rates and scaling on the card, per-image
     LOST f32 in both regimes and for --exact-shapes. Prints train e2e, step,
     decode-only and evaluate img/s, per-image LOST e2e img/s and p50, and
     the peak device memory.
 15. explain and model-vs-human (``explain_phase``): rows 1 and 12-13 f32
     against their plain versions at explain-eval's ViT-B/16 shape (B*H =
     1*12, T = 769, hd 64, no key mask; SDPA and its backward as the
     library calls); ``explain-eval --model vit_b_16`` (full width and
     depth, seed-0 weights, 50% global magnitude masks, a .pth through the
     port's exporter) on the first 2 of the 8 fixture JPEGs with
     SegmentationClass PNGs drawn from their XML boxes, each at its own
     size padded to 16: 11 flash forwards a model forward (the last block returns
     its attention), 11 flash backwards an IG gradient (2 x 50 of them),
     none for GradCAM's backward, asserted exactly, 0 launches of every
     other row; the three txt files; e2e img/s and ms per method an image;
     ``explain`` with all five methods on ViT-B/16 and with its defaults
     on ResNet-50 over 2 classes of 224 crops (figures when matplotlib
     imports here; otherwise the CLI must fail with its ImportError and
     the heatmaps and .npy writes run through ``compute_heatmaps``); the
     card's f32 ``compute_heatmaps`` against the CPU's at the 512x288
     image (IG at 4 steps, the same CPU-drawn SmoothGrad noise): GradCAM,
     IG and the attention map within 1e-4 of each map's scale, RMA within
     1e-4 and RRA within 1e-3; LRP (ill conditioned in f32 over 12 blocks,
     at eps 1e-2 as at its 1e-6) finite, for the same target, at cosine
     >= 0.999 with the CPU's at eps 1e-2, the card's (flash and einsum
     routes) and the CPU's distances from an f64 CPU run printed; IG's profile (wall, device
     busy share, kernels a gradient, GEMM and flash shares); ``mvh`` on
     ResNet-50 and ViT-B/16 (B=1, 1 batch of 224 crops, no checkpoint):
     the CSV's 19 rows, distorted img/s and the share of the host's numpy
     distortions; 0 launches in explain and mvh.
 16. the DINO ViTs, cluster and dropout (``dino_phase``), random weights
     from seed 0: dino_vit_small (patch 16, D 384, 12 blocks, 6 heads)
     through the batched LOST pipeline on 512x384 uint8 images in f32 and
     bf16 on an exact-fit and a mixed bucket (a batch: 12 flash launches,
     and 12 fused-MLP launches at D = 384 in bf16), img/s at B=128 and p50
     at B=1, card vs CPU on its first 2 blocks at B=2 (f32 features within
     1e-3 of their scale, boxes equal up to ties); dino_vit_tiny (D = 192)
     and dino_vit_base (D = 768) in bf16 (launches, img/s); row 4 at D =
     192 (F = 768, M = 128*896) against its plain version, timed beside the
     library's layer_norm -> linear -> gelu(tanh); dino_vit_small at patch 8
     (T = 3073 -> 3200) bf16 at B=32 (img/s, launches) and row 1 at that T
     (B*H = 8*6) against its plain version and SDPA with the bool mask;
     ``lost --arch dino --model dino_vit_small --dtype bf16`` from a .pth
     in facebookresearch/dino's keys on 128 fixture JPEGs (launches, first
     batch against the pipeline, txt against ``corloc``, e2e img/s);
     ``--dinoseg`` with ``--arch dino`` and ``--arch vit --model vit_s_16``
     on 32 JPEGs one at a time (11 flash launches an image: the last block
     computes its attention; per-image img/s; the first 2 boxes equal to a
     CPU run's); ``cluster --nb-clusters 20`` on the first 32 boxes of the
     lost run's preds.pkl (crops/s; embeddings within 1e-4 of their scale
     of a CPU run's, the labels equal); VGG16 through ``train --amp`` (SNIP to 50%, LRR one
     iteration; one epoch each on phase 12's ImageFolder, B=128; no kernel
     launch; e2e and step img/s, peak memory), its dropout on the card
     (keep shares within a binomial 5-sigma band, a resumed step drawing
     the same masks) and card vs CPU at dropout rate 0 (2 f32 steps, no
     farther from an f64 CPU run than 2x the CPU's f32); a bf16 ViT-B/16
     train step at 224 and 384 with attention dropout 0.1 (no launch of
     rows 1, 5-8 and 12-13) and at 0 (phases 7's and 8's launches).
 17. structured slimming (``slim_phase``): row 4 at M = 128*896, D = 384
     and a slimmed MLP's F = 768 and F = 461 (the any-F tail), row 1 f32
     and bf16 at B*H = 128*4 and 128*3, T = 896 with the bucket mask, each
     against its plain version with its bound and the library's time;
     ViT-S/16 at full width (seed 0, a 50% global magnitude mask, then in
     every block the even MLP neurons' fc2 rows and heads 1 and 4's out
     rows zero) as a .pth through ``vipers_torch slim --mlp-keep 0.5
     --heads-keep 0.5`` (exact: F = 768, 4 heads) and ``--round-to 1
     --mlp-keep 0.3 --heads-keep 0.5`` (F = 461, 3 heads), each through
     ``lost --arch vit`` at B=128 on 128 synthetic 512x384 JPEGs in bf16
     and f32 (12 flash launches a batch, 12 fused MLP in bf16; the txt
     against ``corloc``; e2e img/s); the exact slim's f32 features on the
     card within 1e-4 of the masked dense model's scale, boxes agreeing
     counted; ``vipers_torch.tools.bench_slim``'s dense-vs-slim img/s, bf16
     and f32; ViT-B/16 slimmed to 6 heads and mlp 1536, ``train --amp
     --resume`` of it (SNIP to 50%, 2 steps of 64 at 224: rows 7-8 at B*H =
     64*6, 12 launches each a step, held against their plain versions; no
     fused MLP at B=64; sidecars on every checkpoint) and ``evaluate`` of the dense and slim
     checkpoints; ResNet-50 (``--inner-keep 0.5``), VGG16 (``--conv-keep
     0.5 --fc-keep 0.5``) and swin_v2_t (``--mlp-keep 0.5``) through
     ``slim`` and ``evaluate`` of both checkpoints, 0 launches.
 18. int8 quantization (``quantize_phase``): the card's int32
     accumulators of ``matmul_int32`` (cuBLASLt's int8 GEMM through
     ``torch._int_mm``, zero-padded where it refuses a shape) and
     ``conv_int32`` (im2col + GEMM; depthwise per tap) at the int8 paths'
     shapes (ViT-S/16 and ViT-B/16 LOST GEMMs at M = 128*896, the heads, M
     <= 16, K = 9; mobilenet_v2's and ResNet-50's convolutions at 224,
     B=128), extreme operands included, equal to the CPU's int32; row 1
     bf16 at the int8 LOST shapes (B*H = 128*6 and 128*12, T = 896, 769
     tokens) against its plain version; ``lost --dtype int8``'s pipeline on
     full-width ViT-S/16 (seed 0, 50% mask) at 512x384, B=128, dynamic
     qparams, exact-fit and mixed buckets: 12 bf16 flash launches and 26
     ``_int_mm`` calls a batch, 0 fused MLP; int8 and bf16 img/s and p50;
     card vs CPU on its first 2 blocks (features within 2e-2 of their
     scale, boxes equal up to ties); ``quantize --mode ptq`` of phase 12's
     ViT-B/16 checkpoint (f32, 2 calibration batches of 128, 26 sites),
     then ``lost --model vit_b_16 --dtype int8`` from the .pth it writes
     (static qparams) on 256 JPEGs (12 flash launches a batch, 0 fused
     MLP); ``quantize --mode ptq`` and one QAT epoch (2 steps of 128,
     f32) on quantized_mobilenet_v2 and quantized_resnet50 at 224 on phase
     12's ImageFolder: no launch, finite losses and observers, the JAX
     package's lines and files.
 19. serving export (``export_phase``): row 1 f32 and bf16 against its
     plain version at the exported ViT-B/16 LOST shape (B*H = 128*12, T =
     896, 769 tokens); ``vipers_torch export --pipeline lost --verify`` of
     phase 12's ViT-B/16 checkpoint at 384x512, B=128, in bf16 and f32, and
     of phase 18's PTQ checkpoint in int8 (no ``--verify``), the artifacts
     then loaded and run in a fresh process that imports only torch and
     ``vipers_torch.ops`` (the ResNet-50 and classify exports below run in
     this process meanwhile):
     12 row-1 launches a batch, 12 row-4 launches in bf16 and 0 in f32 and
     int8, as many ``torch._int_mm`` calls as the eager int8 batch (26),
     boxes, seeds and background flags equal to the eager pipeline's on the
     same 128 images (up to top-score ties); ResNet-50 ``--pipeline lost``
     at its canonical bucket (no kernel launch, boxes equal to the eager
     CNN pipeline's); ViT-B/16 classify bf16 at 224 ``--verify``;
     ``vipers_torch.tools.bench_export``'s eager and artifact img/s (its
     ViT-S/16 programs cut to 6 blocks since phase 21).
 20. mobilenet_v2, DINO explain and the debugging surface
     (``debug_surface_phase``): mobilenet_v2 (seed 0, 50% global magnitude
     mask) through ``lost --arch mobilenet`` on 128 fixture JPEGs in bf16
     and f32 and on 32 of them with ``--exact-shapes``, its CNN pipeline at the 512x384 canonical
     bucket (img/s at B=128, p50 at B=1), card vs CPU at B=4 at full depth
     (features 1e-3 of their scale, boxes equal up to top-score ties), and
     ``quantized_mobilenet_v2`` ``lost --dtype int8`` from phase 18's PTQ
     ``.pth`` with every int32 accumulator of a B=2 forward equal to the
     CPU's: 0 attention or fused-MLP launches on every mobilenet path; rows
     1 and 12-13 f32 against their plain versions at ``dino_vit_small``'s
     explain shape (B*H = 1*6, T = 769), ``explain-eval`` on mobilenet_v2
     and dino_vit_small (2 VOC-sized images; 11 flash blocks x 102 forwards
     and x 100 backwards an image counted on DINO, 0 on mobilenet), the
     heatmaps card vs CPU within 1e-4 (DINO cut to 2 blocks; LRP, and
     MobileNetV2's IG, whose f32 map lies ~1e-2 of its scale from f64 on
     the CPU too, by cosine >= 0.999); rows 1 (B*H = 1*6, T = 896) and 4 (M = 896)
     bf16 against their plain versions at the per-image shape, ``lost
     --visualize pred`` and ``seed_expansion`` on ViT-S/16 bf16 (12 + 12
     launches an image counted) and mobilenet_v2 (0) on 8 JPEGs: one
     drawing an image, the boxes equal to the batched run's; ``train
     --profile-dir`` on ViT-S/16 ``--amp`` at 224 for one epoch: one Chrome
     trace naming the training attention kernels (rows 7-8); ``train
     --debug-nans`` on a ViT-S/16 with one NaN weight raises
     ``FloatingPointError`` on the card.
 21. data parallelism (``ddp_phase``): a one-rank NCCL group on the card,
     the data-parallel ResNet-50 bf16 step (224, B=32, full width, its
     gradients all-reduced through NCCL) equal to the plain step after 3
     steps (cuDNN deterministic for both), both timed; then the port's
     ``train``, ``evaluate``, ``quantize --mode ptq`` and ``lost`` as 2
     ranks sharing the card over gloo (child processes joined through the
     port's own initializer; NCCL refuses two ranks on one card) against
     one process at the global batch: ResNet-50 SNIP (f32, from the seed-0
     weights with BatchNorm biases at +3, 224, B=16 a rank, 2 steps and the
     epoch-end eval on 41 val images, a sentinel row on rank 1), ViT-B/16
     ``--amp`` SNIP (2 steps), ``evaluate`` and PTQ of a seed-0 ResNet-50
     .pth, ``lost`` of a seed-0 ViT-S/16 .pth in bf16 on 64 fixture JPEGs
     (B=32 a rank, the process B=64). While the children start: a witness
     of what BatchNorm's reduction order alone does to 2 ResNet-50 f32
     steps in one process, from the seed-0 weights and from biases +3
     (printed, not held), and the memory of SNIP on a gathered global
     batch (rank 0's pass) of ResNet-50 and ViT-B/16 at 128 and 256
     images. Checks: the printed accuracy lines of every rank equal to the
     process's, SNIP masks equal, parameters and statistics after 2 steps
     within rtol 5e-2 / atol 3e-3, the evaluate rows and int8 counts
     equal, observers within 1e-4, ``preds.pkl`` and the results txt
     equal; rows 7-8 24 launches on every rank (12 a step), rows 1 and 4
     12 a LOST batch on every rank (``ddp_launches`` in the kernels JSON);
     which gloo collectives take CUDA tensors; each stage's
     seconds, 2 ranks on one card beside one process. The same children
     then run the model-parallel paths against one process at the same
     global batch (``mp_stages``): ViT-B/16 ``train --amp --model-parallel
     2`` (224, B=128, SNIP, 2 steps, the eval on 128 images) and
     ``--pipeline-parallel 2 --pp-microbatch 128`` (B=256, SNIP, 2 steps,
     the pipelined eval), ``lost --sequence-parallel`` on 8 fixture JPEGs
     (ViT-S/16 f32, dino_vit_small bf16) and the ViT-S/16 f32 features of
     ``extract`` under sequence parallelism: masks, boxes and txt equal,
     parameters within rtol 5e-2 / atol 3e-3, the gathered ``.pth`` in one
     process's keys and shapes, features 1e-3 of their scale; rows 7-8 24
     launches and row 4 (F = 1536) 12 on each TP rank, rows 7-8 24 and row
     4 6 on each PP stage, rows 1 and 4 0 on each SP rank; the gloo
     send/recv probe (the pipeline's route: through pinned host memory).
     ``python chip_smoke.py --nccl 4`` runs those model-parallel paths on 4
     cards over NCCL (2 data ranks under TP and PP) against one process,
     the same checks: not part of the one-card run.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object listing the kernels (the rows
phase 6 drove also carry its launches as ``cli_launches``, the rows phase
12 drove its as ``train_cli_launches``, the row phase 19's bf16 program
drove as ``export_launches``, the rows phase 21's runs drove their
launches on each rank as ``ddp_launches``); the last is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W, PATCH = 512, 384, 16
BATCH = 128
SPARSITY = 0.5
K_PATCHES = 100
N_CPU = 4
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
PEAK_TF32 = 494.7e12  # TF32 tensor cores, dense: the f32 flash kernels' 3xTF32 products
TRAIN_HW, TRAIN_BATCH = 224, 128
TRAIN_HW_FLASH = 384  # the ViT/DeiT fine-tuning resolution: T = 577 takes flash
N_JPEG, N_JPEG_SHORT = 1024, 256  # JPEG -> CorLoc runs: bf16, then f32 and packed bf16
REPO = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_tile(fa, dtype, head_dim=64):
    """The attention forward tile's shape for ``dtype`` at ``head_dim`` as
    compiled, for the flash and packed lines."""
    d = fa.tile_shape(dtype, head_dim)
    if dtype == torch.bfloat16:
        return "; tile {block_q} x {block_k}, {stages} stages".format(**d)
    return ("; tile {block_q} queries x {block_k}-key stages, {stages} raw stages, "
            "{split_stages} split stages, every product {tf32_products} TF32 products "
            "(3xTF32)".format(**d))


def forward_bound(flops, nbytes, dtype, ms):
    """The bound of an attention forward of ``flops`` and ``nbytes`` and the
    kernel's share of it: bf16 on the bf16 tensor cores; f32 as 3xTF32
    (three times the FLOPs on the TF32 tensor cores), with the share of
    the FMA bound beside it. Returns (bound ms, bounded by, text)."""
    if dtype == torch.bfloat16:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        return bms, by, f"{bms / ms:.1%} of the bound"
    bms, by = bound(3 * flops, nbytes, PEAK_TF32)
    fma_ms = bound(flops, nbytes, PEAK_F32)[0]
    return bms, by, (f"{bms / ms:.1%} of its 3xTF32 bound {bms:.3f} ms, {fma_ms / ms:.1%} of "
                     f"its FMA bound {fma_ms:.3f} ms")


def bwd_design(fa, dtype, hd=64):
    """The flash backward's design for ``dtype`` at ``hd`` as compiled, for
    its line."""
    d = fa.bwd_design(dtype, hd)
    arith = (f"; every product {d['tf32_products']} TF32 products (3xTF32)"
             if d["tf32_products"] else "")
    return (f"; {d['kernels']} kernels after a row pass (D, lse in log2 units): dk/dv on "
            f"{d['dkv_keys']}-key tiles over {d['dkv_queries']}-query stages, "
            f"{d['dkv_stages']} stages; dq on {d['dq_queries']}-query tiles over "
            f"{d['dq_keys']}-key stages, {d['dq_stages']} stages{arith}")


def check_flash_at(fa, dtype, gen, shape, grid_hw, pad_from, tag=None, all_invalid=False,
                   pad_rows=slice(1, None, 2)):
    """The flash kernel vs plain at ``shape`` = (B, H, T, hd): the CLS token
    and a (gh, gw) = ``grid_hw`` patch grid valid, the rest of T seq pad;
    on the images ``pad_rows`` (every other one) the grid's rows and
    columns from ``pad_from`` on bucket pad; with ``all_invalid`` the last
    image attends no key. The row's name carries ``tag``. The bound counts
    the valid query x valid key pairs of each image: the outputs of pad
    queries are never read."""
    b, h, t, hd = shape
    n_valid = 1 + grid_hw[0] * grid_hw[1]
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n_valid] = True
    grid = valid[pad_rows, 1:n_valid].view(-1, *grid_hw)
    grid[:, pad_from[0]:, :] = False
    grid[:, :, pad_from[1]:] = False
    if all_invalid:
        valid[-1] = False
    key = fa.launch_key(dtype, hd)
    n0 = fa.LAUNCHES[key]
    out, lse = fa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == n0 + 1, fa.LAUNCHES
    want, want_lse = fa.flash_attention_plain(q, k, v, valid)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        tol = f"atol 1e-5 rtol 1e-4; lse {lse_err:.2e} (atol 1e-4 rtol 1e-4)"
    else:
        scale = want.float().abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        tol = f"2e-2 of output scale {scale:.3g}; lse {lse_err:.2e} (atol 1e-3)"
    del want, want_lse
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, valid))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, valid), reps=3, warmup=1)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    pairs = int((valid.sum(dim=1).double() ** 2).sum())
    flops = 4 * h * pairs * hd
    nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4 + valid.numel()
    bms, by, shares = forward_bound(flops, nbytes, dtype, ms)
    name = "f32" if dtype == torch.float32 else "bf16"
    name = f"flash_attention_fwd[{name}{'' if tag is None else f', {tag}'}]"
    print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.0f} TFLOP/s, {shares}{attention_tile(fa, dtype, hd)}) "
          f"plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP on {pairs / (b * t * t):.1%} of the T x T pairs, "
          f"{nbytes / 1e6:.0f} MB) at B*H = {b}*{h}, T = {t} ({n_valid} tokens), hd {hd}")
    return {"name": name, "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_fwd.cu",
            "replaces": "vipers/ops/flash_attention.py:91",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def check_flash_bwd(fa, dtype, gen, shape=(TRAIN_BATCH, 6, 640, 64), n_valid=577, ragged=300):
    """Flash backward kernel vs plain at the 384x384 train shape: B*H =
    128*6, T = 640 (577 tokens seq-padded; a ragged run of pad keys inside
    the 577, from key 300, on every other image; the last image attends no
    key), hd = 64 (or ``shape``, ``n_valid`` tokens, pad keys from
    ``ragged``: vit_h_14's 392x392 train shape at hd 80), residuals from the
    forward kernel, cotangents on every row (so the kernel is held to the
    plain version on every row): each of dq, dk, dv within 1e-4 (f32) or
    2e-2 (bf16) of its scale, and two calls bit-equal. f32: the plain
    version in exact f32 (cuBLAS TF32 off), and the kernel at least 10x
    nearer it than the same plain version in cuBLAS TF32 (one TF32 product
    a product, the yardstick). Library: ``torch.autograd.grad`` of SDPA with
    the bool mask."""
    b, h, t, hd = shape
    f32 = dtype == torch.float32
    q, k, v, cot = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(dtype)
                    for _ in range(4))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n_valid] = True
    valid[1::2, ragged:n_valid:3] = False
    valid[-1] = False
    scale = hd ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, valid, scale)
    args = (q, k, v, valid, out, lse, cot, scale)
    key = fa.launch_key(dtype, hd)
    n0 = fa.BWD_LAUNCHES[key]
    got = fa.flash_attention_bwd(*args)
    again = fa.flash_attention_bwd(*args)
    assert fa.BWD_LAUNCHES[key] == n0 + 2, fa.BWD_LAUNCHES
    assert not torch.backends.cuda.matmul.allow_tf32, "the plain reference must be exact f32"
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "backward not deterministic"
    frac = 1e-4 if f32 else 2e-2
    errs = [scaled_err(a, c, frac) for a, c in zip(got, want)]
    yard = ""
    if f32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fa.flash_attention_bwd_plain(*args)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        y_errs = [(y.float() - c.float()).abs().max().item() for y, c in zip(tf32, want)]
        near = min(ye / e if e else float("inf") for ye, (e, _) in zip(y_errs, errs))
        assert near >= 10, (near, y_errs, errs)
        yard = (f"; cuBLAS-TF32 yardstick {max(y_errs):.3e}, worst "
                f"{max(ye / sc for ye, (_, sc) in zip(y_errs, errs)):.2e} of a scale, the "
                f"kernel {near:.0f}x nearer f32")
    ms = cuda_ms(lambda: fa.flash_attention_bwd(*args))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), reps=5)
    lib_ms = sdpa_bwd_ms(q, k, v, cot, valid[:, None, None, :])
    n = q.numel()
    flops = 10 * b * h * t * t * hd  # the function: five T x T x hd products
    nbytes = 8 * n * q.element_size() + lse.numel() * 4 + valid.numel()
    # both instances split dk/dv from dq as the library does: S and dP twice
    design_flops = 14 * b * h * t * t * hd
    name = f"flash_attention_bwd[{'f32' if f32 else 'bf16'}{'' if hd == 64 else f', hd{hd}'}]"
    if f32:
        # every f32 product is three TF32 products on the tensor cores
        bms, by = bound(3 * flops, nbytes, PEAK_TF32)
        design_ms = bound(3 * design_flops, nbytes, PEAK_TF32)[0]
        fma_ms, fma_design_ms = (bound(f, nbytes, PEAK_F32)[0] for f in (flops, design_flops))
        shares = (f"{bms / ms:.1%} of its 3xTF32 bound {bms:.3f} ms, {fma_ms / ms:.1%} of its FMA "
                  f"bound {fma_ms:.3f} ms; {design_flops / ms / 1e9:.0f} TFLOP/s done, "
                  f"{design_ms / ms:.1%} of the 3xTF32 bound {design_ms:.3f} ms and "
                  f"{fma_design_ms / ms:.1%} of the FMA bound {fma_design_ms:.3f} ms of the "
                  f"{design_flops / 1e9:.1f} GFLOP the split does")
    else:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        design_ms = bound(design_flops, nbytes, PEAK_BF16)[0]
        shares = (f"{bms / ms:.1%} of its bound; {design_flops / ms / 1e9:.0f} TFLOP/s done, "
                  f"{design_ms / ms:.1%} of the bound of the {design_flops / 1e9:.1f} GFLOP the "
                  f"split does, {design_ms:.3f} ms")
    print(f"{name} max_abs_err {max(e for e, _ in errs):.3e} ({frac:g} of each of dq, dk, dv's "
          f"scale ({', '.join(f'{sc:.3g}' for _, sc in errs)}); worst "
          f"{max(e / sc for e, sc in errs):.2e} of it; two calls bit-equal{yard}) kernel "
          f"{ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s of the function's work, {shares}"
          f"{bwd_design(fa, dtype, hd)}) plain {plain_ms:.3f} ms sdpa-backward {lib_ms:.3f} ms "
          f"bound {bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB) at B*H = "
          f"{b}*{h}, T = {t} ({n_valid} valid keys), hd {hd}")
    return {"name": name, "route": "cuda", "source": "vipers_torch/csrc/flash_attention_bwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                        "(_flash_attention_bwd_dkv) and :1287 (_flash_attention_bwd_dq)",
            "max_abs_err": max(e for e, _ in errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def fused_mlp_inputs(fm, m, d, f, gen):
    """x (m, d) bf16 and the folded (W_eff^T, b_eff) of a LayerNorm and fc1,
    plus the unfolded bf16 weights for the library's sequence."""
    x = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.3 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    kernel = torch.randn(d, f, generator=gen, device="cuda") / d ** 0.5
    bias = 0.1 * torch.randn(f, generator=gen, device="cuda")
    w_eff_t, b_eff = fm.fold_ln_affine(gamma, beta, kernel, bias, torch.bfloat16)
    lib_w = (gamma.bfloat16(), beta.bfloat16(), kernel.t().contiguous().bfloat16(),
             bias.bfloat16())
    return x, w_eff_t, b_eff, lib_w


def fused_mlp_design(fm, d):
    ds = fm.design(d)
    return (f"{ds['rows']} rows a CTA, {ds['block_n']}-column tiles, {ds['stages']} W_eff stages "
            f"of 64 k, "
            f"{'an epilogue warpgroup a consumer' if ds['staged'] else 'epilogue in the consumer'}")


def fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w):
    """Kernel and layer_norm+linear+gelu milliseconds, and the bound."""
    (m, d), f = x.shape, w_eff_t.shape[0]
    g16, b16, wt16, bb16 = lib_w
    ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff))
    lib_ms = cuda_ms(lambda: F.gelu(F.linear(F.layer_norm(x, (d,), g16, b16, 1e-6),
                                             wt16, bb16), approximate="tanh"))
    flops = 2 * m * d * f
    nbytes = (x.numel() + w_eff_t.numel() + m * f) * 2 + b_eff.numel() * 4
    bms, by = bound(flops, nbytes, PEAK_BF16)
    line = (f"kernel {ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s, {bms / ms:.1%} of the bound; "
            f"{fused_mlp_design(fm, d)}) layer_norm+linear+gelu {lib_ms:.3f} ms bound "
            f"{bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
    return ms, lib_ms, bms, by, line


def check_fused_mlp(fm, gen, m=BATCH * 896, tag=None):
    """Fused LN->fc1->GELU kernel vs plain at (m, 384) x (384, 1536), m =
    128*896 on the LOST path: 2e-2 of the output scale (the kernel's tanh
    is tanh.approx.f32, the plain version's torch.tanh). The row's name
    carries ``tag``."""
    d, f = 384, 1536
    name = f"fused_ln_fc1_gelu[bf16{'' if tag is None else f', {tag}'}]"
    x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
    out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
    want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
    torch.cuda.synchronize()
    err, scale = scaled_err(out, want)
    ms, lib_ms, bms, by, line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)
    plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6), reps=5)
    print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {scale:.3g}) "
          f"{line} plain {plain_ms:.3f} ms at M = {m}")
    return {"name": name, "route": "cuda",
            "source": "vipers_torch/csrc/fused_mlp.cu",
            "replaces": "vipers/ops/fused_mlp.py:123",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "tflops": 2 * m * d * f / ms / 1e9, "share_of_bound": bms / ms,
            "design": fm.design(d)}


def check_fused_mlp_wide(fm, gen):
    """The fused MLP at vit_b's and vit_h's widths, (16*896, D) x (D, 4D)
    for D = 768 and 1280 (the one-consumer instance): the kernel against
    its plain version (2e-2 of the output scale), and its time beside the
    layer_norm+linear+gelu sequence's, with no gate on the times."""
    m = 16 * 896
    for d in (768, 1280):
        f = 4 * d
        x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
        out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
        want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)[-1]
        print(f"fused_ln_fc1_gelu[bf16, D={d}, F={f}, M={m}] max_abs_err {err:.3e} (2e-2 of "
              f"output scale {sc:.3g}) {line}")


def check_fused_mlp_family(fm, gen, shapes=((768, BATCH * 896), (1024, BATCH * 896),
                                             (1280, BATCH * 1024))):
    """The fused MLP at the ViT family's LOST shapes (D, M), F = 4D: D = 768
    (vit_b_16, M = 128*896), 1024 (vit_l_16, M = 128*896) and 1280 (vit_h_14,
    M = 128*1024), each against its plain version (2e-2 of the output
    scale) with the kernel's, the plain version's and the library
    sequence's times and the bound."""
    rows = []
    for d, m in shapes:
        f = 4 * d
        x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
        out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
        want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        del out, want
        ms, lib_ms, bms, by, line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)
        plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6),
                           reps=3, warmup=1)
        name = f"fused_ln_fc1_gelu[bf16, D={d}]"
        print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {sc:.3g}) {line} plain "
              f"{plain_ms:.3f} ms at M = {m}, F = {f}")
        rows.append({"name": name, "route": "cuda", "source": "vipers_torch/csrc/fused_mlp.cu",
                     "replaces": "vipers/ops/fused_mlp.py:123", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "design": fm.design(d)})
    return rows


def check_flash_packed(fa, dtype, gen):
    """Packed token-major kernel vs plain at the LOST shape: B = 128, T =
    896, D = 384 in 6 heads, the (B, T, 3D) qkv in head-pair stripes, 769
    valid keys on every other image. SDPA runs on the unpacked strided
    views with the bool mask."""
    b, t, heads, hd = BATCH, 896, 6, 64
    d = heads * hd
    qkv = torch.randn(b, t, 3 * d, generator=gen, device="cuda").to(dtype)
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    valid[1::2, 769:] = False
    scale = hd ** -0.5
    out = fa.flash_attention_packed_fwd(qkv, valid, heads, scale)
    want = fa.flash_attention_packed_plain(qkv, valid, heads, scale)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        tol = "atol 1e-5 rtol 1e-4"
    else:
        sc = want.float().abs().max().item()
        assert err <= 2e-2 * sc, (err, sc)
        tol = f"2e-2 of output scale {sc:.3g}"
    ms = cuda_ms(lambda: fa.flash_attention_packed_fwd(qkv, valid, heads, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_packed_plain(qkv, valid, heads, scale),
                       reps=5)
    q, k, v = fa._unpack_bhtd(qkv, heads)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    flops = 4 * b * heads * t * t * hd
    nbytes = (qkv.numel() + out.numel()) * qkv.element_size() + valid.numel()
    bms, by, shares = forward_bound(flops, nbytes, dtype, ms)
    name = f"flash_attention_packed[{'f32' if dtype == torch.float32 else 'bf16'}]"
    print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms ({flops / ms / 1e9:.0f} "
          f"TFLOP/s, {shares}{attention_tile(fa, dtype)}) plain {plain_ms:.3f} ms "
          f"sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.0f} MB)")
    return {"name": name, "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_packed.cu",
            "replaces": "vipers/ops/flash_attention.py:358",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def scaled_err(got, ref, frac=2e-2):
    """Max abs error of ``got`` against ``ref``, asserted within ``frac`` of
    ``ref``'s scale (its max abs); returns (error, scale)."""
    sc = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * sc, (err, sc)
    return err, sc


def own_variant(got, want, want_f32):
    """A softmax variant differs from f32 by less than 2e-2 of the output's
    scale, so the tolerance alone would pass an instance that computed f32.
    This asserts that ``got`` is clearly its own variant: its mean distance
    from the variant's plain version ``want`` is at most half the distance
    from ``want`` to f32's plain version ``want_f32`` (so it also lies
    farther from ``want_f32`` than from ``want``). Returns that ratio."""
    gap = (want.float() - want_f32.float()).abs().mean().item()
    ratio = (got.float() - want.float()).abs().mean().item() / gap if gap else float("inf")
    assert ratio <= 0.5, (ratio, gap)
    return ratio


def train_design(at, hd=64):
    """The training attention kernels' compiled design at ``hd``, for their
    lines."""
    d = at.design(hd)
    return (f"; forward {d['fwd_block_q']}-query tiles, {d['chunk']}-key chunks, "
            f"{d['fwd_stages']} K/V stages, K/V loaded by every tile (the other query tile of "
            f"a head reads it from L2); backward {d['bwd_block_q']}-query blocks, "
            f"{d['bwd_stages']} stages, {d['bwd_chunk']} keys a round")


def attention_rows(checks, design=""):
    """Print one line and make one row of the kernels JSON for each
    (name, ms, plain ms, library ms, flops, bytes, error, tolerance text,
    replaces) of a bf16 attention kernel check; ``design`` ends each line."""
    rows = []
    for name, ms, plain, lib, flops, nbytes, err, tol, rep in checks:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        lib_name = "sdpa" if "fwd" in name else "sdpa-backward"
        print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms ({bms / ms:.1%} of the "
              f"bound{design}) plain {plain:.3f} ms {lib_name} {lib:.3f} ms bound {bms:.3f} ms "
              f"({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vipers_torch/csrc/attention_train.cu", "replaces": rep,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib})
    return rows


def sdpa_bwd_ms(q, k, v, cot, amask):
    """Median ms of ``torch.autograd.grad`` of SDPA alone (retained graph)."""
    lq, lk, lv = (z.detach().clone().requires_grad_(True) for z in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
    return cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), cot, retain_graph=True))


def attention_work(b, h, t, hd, valid):
    """(flops, bytes) of the training attention forward and backward."""
    n, lse_bytes = b * h * t * hd, b * h * t * 4
    return ((4 * b * h * t * t * hd, 4 * n * 2 + lse_bytes + valid.numel()),
            (10 * b * h * t * t * hd, 8 * n * 2 + lse_bytes + valid.numel()))


def check_attention_train(at, gen, shape=(TRAIN_BATCH, 6, 256, 64), n_valid=197, ragged=120,
                          tag=None):
    """Training attention kernels vs plain at the train shape: B*H = 128*6,
    T = 256 (197 tokens seq-padded; on every other image a ragged run of pad
    keys inside the 197, from key 120), hd = 64 (or ``shape``, ``n_valid``
    tokens, pad keys from ``ragged``: vit_h_14's 224x224 train shape at hd
    80), bf16, packed (3, B, H, T, hd) q|k|v with the backward writing one
    packed dqkv; one launch of the head dim's instance each way. The rows'
    names carry ``tag``."""
    b, h, t, hd = shape
    qkv = torch.randn(3, b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n_valid] = True
    valid[1::2, ragged:n_valid:3] = False
    q, k, v = qkv.unbind(0)
    scale = hd ** -0.5
    n0 = dict(at.LAUNCHES)
    out, lse = at.attention_train_fwd(q, k, v, valid, scale)
    dqkv = torch.empty_like(qkv)
    at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, out=dqkv.unbind(0))
    fk, bk = (at._launch_key(kind, "f32", hd) for kind in ("fwd", "bwd"))
    assert at.LAUNCHES == {**n0, fk: n0[fk] + 1, bk: n0[bk] + 1}, at.LAUNCHES
    want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale)
    want_g = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()

    fwd_err, fwd_scale = scaled_err(out, want)
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= 1e-3, lse_err
    bwd = [scaled_err(dqkv[i], want_g[i]) for i in range(3)]
    bwd_err = max(e / sc for e, sc in bwd)

    dbuf = dqkv.unbind(0)
    fwd_ms = cuda_ms(lambda: at.attention_train_fwd(q, k, v, valid, scale))
    fwd_plain = cuda_ms(lambda: at.attention_train_fwd_plain(q, k, v, valid, scale), reps=5)
    amask = valid[:, None, None, :]
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    bwd_ms = cuda_ms(lambda: at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale,
                                                    out=dbuf))
    bwd_plain = cuda_ms(lambda: at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid,
                                                             scale), reps=5)
    bwd_lib = sdpa_bwd_ms(q, k, v, cot, amask)

    (fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes) = attention_work(b, h, t, hd, valid)
    sfx = ("" if hd == 64 else f", hd{hd}") + ("" if tag is None else f", {tag}")
    at_shape = f" at B*H = {b}*{h}, T = {t} ({n_valid} valid keys), hd {hd}"
    return attention_rows((
        (f"attention_train_fwd[bf16{sfx}]", fwd_ms, fwd_plain, fwd_lib, fwd_flops, fwd_bytes,
         fwd_err, f"2e-2 of output scale {fwd_scale:.3g}; lse {lse_err:.2e} (atol 1e-3)",
         "vipers/ops/attention_train.py:276"),
        (f"attention_train_bwd[bf16{sfx}]", bwd_ms, bwd_plain, bwd_lib, bwd_flops, bwd_bytes,
         max(e for e, _ in bwd), "2e-2 of each of dq, dk, dv's scale "
         f"({', '.join(f'{sc:.3g}' for _, sc in bwd)}); worst {bwd_err:.2e} of it",
         "vipers/ops/attention_train.py:294")), train_design(at, hd) + at_shape)


def check_attention_train_rounds(at, gen):
    """The training kernels beyond one 256-key chunk, which the main path
    does not run: B*H = 8*6, T = 640 (577 tokens seq-padded, a ragged run of
    pad keys on every other image), packed q|k|v: the two-pass forward and
    the backward's key rounds with dQ summed in the f32 scratch, against the
    plain versions (2e-2 of each output's scale, lse atol 1e-3)."""
    b, h, t, hd = 8, 6, 640, 64
    qkv = torch.randn(3, b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :577] = True
    valid[1::2, 300:577:3] = False
    q, k, v = qkv.unbind(0)
    scale = hd ** -0.5
    out, lse = at.attention_train_fwd(q, k, v, valid, scale)
    dqkv = torch.empty_like(qkv)
    at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, out=dqkv.unbind(0))
    want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale)
    want_g = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()
    fwd_err, fwd_scale = scaled_err(out, want)
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= 1e-3, lse_err
    bwd = [scaled_err(dqkv[i], want_g[i]) for i in range(3)]
    print(f"attention_train[bf16, T={t}, key rounds] forward max_abs_err {fwd_err:.3e} (2e-2 of "
          f"output scale {fwd_scale:.3g}), lse {lse_err:.2e} (atol 1e-3); backward "
          f"{', '.join(f'{e:.3e}' for e, _ in bwd)} (2e-2 of dq, dk, dv's scale "
          f"{', '.join(f'{sc:.3g}' for _, sc in bwd)})")


def check_softmax_variants(at, gen):
    """The softmax-precision instances of the training kernels (the A/B
    tool's bf16exp and normP forward, bf16exp backward; normP's backward is
    f32's) vs their plain versions at the tool's shape: (128, 6, 256, 64)
    bf16, all keys valid. Each is within 2e-2 of its output's scale and
    clearly its own variant, not f32 (``own_variant``); the backward runs on
    the bf16exp forward's residuals."""
    b, h, t, hd = TRAIN_BATCH, 6, 256, 64
    q, k, v, cot = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(4))
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = hd ** -0.5
    amask = valid[:, None, None, :]
    (fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes) = attention_work(b, h, t, hd, valid)
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    want_f32, _ = at.attention_train_fwd_plain(q, k, v, valid, scale)
    checks = []
    for variant in ("bf16exp", "normP"):
        out, lse = at.attention_train_fwd(q, k, v, valid, scale, variant=variant)
        want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale, variant)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        lse_err = (lse - want_lse).abs().max().item()
        assert lse_err <= 1e-3, lse_err
        ratio = own_variant(out, want, want_f32)
        ms = cuda_ms(lambda: at.attention_train_fwd(q, k, v, valid, scale, variant=variant))
        plain = cuda_ms(lambda: at.attention_train_fwd_plain(q, k, v, valid, scale, variant),
                        reps=5)
        checks.append((f"attention_train_fwd[{variant}]", ms, plain, fwd_lib, fwd_flops,
                       fwd_bytes, err, f"2e-2 of output scale {sc:.3g}; lse {lse_err:.2e} (atol "
                       f"1e-3); "
                       f"own variant: {ratio:.3f} of its gap to f32",
                       "tools/bench_softmax_prec.py:124"))

    out, lse = at.attention_train_fwd(q, k, v, valid, scale, variant="bf16exp")
    grads = at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, variant="bf16exp")
    want = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale, "bf16exp")
    want_f32 = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()
    bwd = [scaled_err(g, w) for g, w in zip(grads, want)]
    ratios = [own_variant(g, w, w32) for g, w, w32 in zip(grads, want, want_f32)]
    ms = cuda_ms(lambda: at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale,
                                                variant="bf16exp"))
    plain = cuda_ms(lambda: at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale,
                                                         "bf16exp"), reps=5)
    checks.append(("attention_train_bwd[bf16exp]", ms, plain, sdpa_bwd_ms(q, k, v, cot, amask),
                   bwd_flops, bwd_bytes, max(e for e, _ in bwd),
                   "2e-2 of each of dq, dk, dv's scale "
                   f"({', '.join(f'{sc:.3g}' for _, sc in bwd)}); own variant: "
                   f"{', '.join(f'{r:.3f}' for r in ratios)} of their gaps to f32",
                   "tools/bench_softmax_prec.py:137"))
    return attention_rows(checks, train_design(at))


def check_splash(sa, gen):
    """Every splash instance vs plain at the A/B's shape: (32, 6, 896, 64)
    bf16, q pre-scaled, K head-dim-minor or seq-minor (a transposed copy).
    SDPA runs without a mask on the same q, k, v with scale 1."""
    b, h, t, hd = 32, 6, 896, 64
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    q = (q * hd ** -0.5).to(torch.bfloat16)
    k_of = {"head_dim_minor": k, "seq_minor": k.transpose(-1, -2).contiguous()}
    want = sa.splash_attention_plain(q, k, v)
    sc = want.float().abs().max().item()
    plain_ms = cuda_ms(lambda: sa.splash_attention_plain(q, k, v), reps=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * q.element_size()
    bms, by = bound(flops, nbytes, PEAK_BF16)
    rows = []
    for bq, bkv, layout in sa.INSTANCES:
        kk = k_of[layout]
        out = sa.splash_attention(q, kk, v, bq, bkv, layout)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * sc, (bq, bkv, layout, err, sc)
        ms = cuda_ms(lambda: sa.splash_attention(q, kk, v, bq, bkv, layout))
        name = f"splash_attention[{sa.instance_name(bq, bkv, layout)}]"
        print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {sc:.3g}) kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.0f} TFLOP/s, {bms / ms:.1%} of the bound) plain "
              f"{plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vipers_torch/csrc/splash_attention.cu",
                     "replaces": "tools/bench_splash.py:79",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib_ms})
    return rows


def make_images(rng, exact_hw, patch=PATCH):
    """Tier-1-padded uint8 images (to ``patch`` multiples), zero beyond the
    exact pixel extent, each with a bright block on textured noise."""
    imgs = []
    for h, w in exact_hw:
        im = np.zeros((-(-h // patch) * patch, -(-w // patch) * patch, 3), np.uint8)
        # random bytes mod 110: quicker to draw on the host than rng.integers
        im[:h, :w] = np.frombuffer(rng.bytes(h * w * 3), np.uint8).reshape(h, w, 3) % 110
        r, c = rng.integers(0, h // 2), rng.integers(0, w // 2)
        im[r:r + h // 3, c:c + w // 3] = rng.integers(170, 256, 3, dtype=np.uint8)
        imgs.append(im)
    return imgs


def compare_with_cpu(tag, spec, params, masks, dtype, ex, imgs, exact_hw, lost_core,
                     n_cpu=N_CPU):
    """B=n_cpu images through the same extractor on the CPU (plain kernel
    versions). f32: features within 1e-3 of their scale and equal boxes
    (a seed may differ only inside a tie at the top score); bf16: print.
    The model's patch size and the images' bucket set the grid."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    patch = spec.patch_size
    cpu = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype, device="cpu")
    sub, hw = imgs[:n_cpu], exact_hw[:n_cpu]
    gin, cin = ex.prepare_batch(sub, patch, exact_hw=hw), cpu.prepare_batch(sub, patch, exact_hw=hw)
    gf = ex.batched_features(*gin).float().cpu()
    cf = cpu.batched_features(*cin).float()
    gbox, gseed, gbg = (z.cpu() for z in ex.make_batched_pipeline(K_PATCHES)(*gin))
    cbox, cseed, cbg = cpu.make_batched_pipeline(K_PATCHES)(*cin)
    scale = cf.abs().max().item()
    ferr = (gf - cf).abs().max().item()
    same_seed = (gseed == cseed)
    same_box = (gbox == cbox).all(dim=1)
    print(f"cpu-vs-card [{tag}] features max_abs_err {ferr:.3e} (scale {scale:.3g}); "
          f"seeds equal {int(same_seed.sum())}/{n_cpu}, boxes equal "
          f"{int(same_box.sum())}/{n_cpu}, bg flags equal {int((gbg == cbg).sum())}/{n_cpu}")
    if dtype == torch.float32:
        assert ferr <= 1e-3 * scale, (ferr, scale)
        grid = (cin[0].shape[1] // patch, cin[0].shape[2] // patch)
        scores = lost_core(cf, cin[3], grid, K_PATCHES)["scores"]
        for i in range(n_cpu):
            if same_seed[i]:
                assert same_box[i] and gbg[i] == cbg[i], (i, gbox[i], cbox[i])
            else:
                s = scores[i]
                assert s[gseed[i]] == s[cseed[i]] == s.max(), (i, gseed[i], cseed[i])


# spec.init(seed 0) trees by model configuration: phases 10 and 11 draw
# vit_h_14's 632M weights (and vit_s_16's) more than once; the cached CPU
# trees are only read (copied to the card), never modified
INIT_CACHE: dict = {}


def seeded_init(spec, seed=0):
    """``spec.init`` from ``seed``, drawn once per model configuration."""
    key = (spec.name, repr(spec.cfg), tuple(spec.input_size), spec.num_classes, seed)
    if key not in INIT_CACHE:
        INIT_CACHE[key] = spec.init(torch.Generator().manual_seed(seed))
    return INIT_CACHE[key]


def seeded_pruned(spec):
    """(``seeded_init(spec)``, its global magnitude masks at ``SPARSITY``
    with ``spec.prune_exclude`` dense), drawn and pruned once per model
    configuration; the masks are ranked on the card (the same masks as on
    the CPU: ``kthvalue`` selects, ties go in index order) and kept on the
    host. Callers write into neither."""
    from vipers_torch.pruning import init_masks, magnitude_prune

    params = seeded_init(spec)
    key = (spec.name, repr(spec.cfg), tuple(spec.input_size), spec.num_classes, "masks")
    if key not in INIT_CACHE:
        on_card = to_device(params, "cuda")
        masks = magnitude_prune(on_card, init_masks(on_card, exclude=spec.prune_exclude),
                                amount=SPARSITY)
        INIT_CACHE[key] = {p: m.cpu() for p, m in masks.items()}
    return params, INIT_CACHE[key]


_REMOVALS: list = []


def remove_later(path):
    """Move the tree ``path`` aside and delete it on a thread (a phase's
    checkpoints take seconds to unlink); ``wait_removals`` joins them."""
    import shutil
    import threading

    trash = f"{path}.removing-{len(_REMOVALS)}"
    os.rename(path, trash)
    thread = threading.Thread(target=shutil.rmtree, args=(trash,),
                              kwargs={"ignore_errors": True})
    thread.start()
    _REMOVALS.append(thread)


def wait_removals():
    for thread in _REMOVALS:
        thread.join()
    _REMOVALS.clear()


def reset_counts(*counters):
    for counts in counters:
        for key in counts:
            counts[key] = 0


def throughput(pipe, inp, one):
    """img/s of ``pipe`` on the batch ``inp`` (3 calls after one warm-up,
    host clock to the boxes on the host) and its p50 ms on the one-image
    batch ``one`` (20 calls after 3)."""
    pipe(*inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = pipe(*inp)
    out[0].cpu()
    ips = 3 * inp[0].shape[0] / (time.perf_counter() - t0)
    lats = []
    for _ in range(23):
        t0 = time.perf_counter()
        pipe(*one)[0].cpu()
        lats.append(1e3 * (time.perf_counter() - t0))
    return ips, statistics.median(lats[3:])


def packed_lost_phase(card, spec, extractors, buckets, default_outs, lost_core):
    """The LOST pipeline on the mixed-size bucket with
    VIPERS_PACKED_ATTENTION=1: launches per forward (12 packed, 0 flash, 12
    fused MLP in bf16), f32 features and boxes against the default route's;
    then bf16 img/s and p50 of both routes on both buckets, measured here
    in turns. Returns the packed launches of the counted forwards."""
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    imgs, hw = buckets["mixed"]
    layers = spec.cfg.num_layers
    inputs = {e: ex.prepare_batch(imgs, PATCH, exact_hw=hw) for e, ex in extractors.items()}
    default_feats = extractors["f32"].batched_features(*inputs["f32"]).float()
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    os.environ["VIPERS_PACKED_ATTENTION"] = "1"
    try:
        torch.cuda.synchronize()
        reset_counts(fa.LAUNCHES, fa.PACKED_LAUNCHES, fm.LAUNCHES)
        outs = {e: pipes[e](*inputs[e]) for e in extractors}
        torch.cuda.synchronize()
        launches = {"flash_attention_packed[f32]": fa.PACKED_LAUNCHES["float32"],
                    "flash_attention_packed[bf16]": fa.PACKED_LAUNCHES["bfloat16"],
                    "flash": sum(fa.LAUNCHES.values()), "fused_mlp": fm.LAUNCHES["bfloat16"]}
        print(f"packed LOST path launches (f32 and bf16 forward, {layers} blocks each): "
              f"{launches}")
        assert launches == {"flash_attention_packed[f32]": layers,
                            "flash_attention_packed[bf16]": layers,
                            "flash": 0, "fused_mlp": layers}, launches
        feats = extractors["f32"].batched_features(*inputs["f32"]).float()
    finally:
        del os.environ["VIPERS_PACKED_ATTENTION"]

    sc = default_feats.abs().max().item()
    ferr = (feats - default_feats).abs().max().item()
    box, seed, bg = (z.cpu() for z in outs["f32"])
    dbox, dseed, dbg = (z.cpu() for z in default_outs)
    same_seed = seed == dseed
    scores = lost_core(default_feats, inputs["f32"][3], (H // PATCH, W // PATCH),
                       K_PATCHES)["scores"].cpu()
    for i in range(BATCH):
        if same_seed[i]:
            assert bool((box[i] == dbox[i]).all()) and bg[i] == dbg[i], (i, box[i], dbox[i])
        else:  # a tie at the top score, broken the same way only by chance
            assert scores[i, seed[i]] == scores[i, dseed[i]] == scores[i].max(), i
    print(f"packed vs default route [f32, mixed] features max_abs_err {ferr:.3e} "
          f"(tol 2e-4 of scale {sc:.3g}); seeds equal {int(same_seed.sum())}/{BATCH}, boxes "
          f"equal {int((box == dbox).all(dim=1).sum())}/{BATCH}")
    assert ferr <= 2e-4 * sc, (ferr, sc)
    ex = extractors["bf16"]
    for b, (b_imgs, b_hw) in buckets.items():
        batch = ex.prepare_batch(b_imgs, PATCH, exact_hw=b_hw)
        one = ex.prepare_batch(b_imgs[:1], PATCH, exact_hw=b_hw[:1])
        os.environ["VIPERS_PACKED_ATTENTION"] = "1"
        try:
            packed_ips, packed_p50 = throughput(pipes["bf16"], batch, one)
        finally:
            del os.environ["VIPERS_PACKED_ATTENTION"]
        default_ips, default_p50 = throughput(pipes["bf16"], batch, one)
        print(f"throughput [bf16, {b}] packed route {packed_ips:.1f} img/s, p50 "
              f"{packed_p50:.2f} ms; default route {default_ips:.1f} img/s, p50 "
              f"{default_p50:.2f} ms at B={BATCH} / B=1 ({card})")
    return launches


# The ViT family phase: each model's bucket (a VOC 500x375 image at its
# patch size: 512x384 at 16 and 32, 504x392 at 14, T = 1009 seq-padded to
# 1024 for vit_h_14) and the cut of vit_h_14's CPU comparison.
FAMILY_HW = {16: (H, W), 32: (H, W), 14: (504, 392)}
VIT_H_CPU_LAYERS, VIT_H_CPU_BATCH = 4, 2


def to_device(tree, dev, dtype=None):
    """A nested dict of tensors on ``dev`` (and in ``dtype``, where given)."""
    return {k: to_device(v, dev, dtype) if isinstance(v, dict) else v.to(dev, dtype)
            for k, v in tree.items()}


@contextlib.contextmanager
def cublas_tf32(on=True):
    """While on, cuBLAS runs f32 matmuls in TF32 (the yardstick the f32
    kernels are held 10x nearer exact f32 than)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def attention_by_einsum(on=True):
    """While on, the models route no attention to a kernel (nor its plain
    version): ``VIPERS_FLASH_MIN_T`` past any T, and T too long for the
    training kernels."""
    old = os.environ.get("VIPERS_FLASH_MIN_T")
    if on:
        os.environ["VIPERS_FLASH_MIN_T"] = str(1 << 30)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VIPERS_FLASH_MIN_T", None)
        else:
            os.environ["VIPERS_FLASH_MIN_T"] = old


def family_model(name, sparsity):
    """A full-width model of the registry as a reference checkpoint has it
    (1000 classes, the pos table at 224x224, interpolated to the bucket by
    the extractor, as ``vipers_torch lost`` runs it), random weights from
    seed 0 moved to the card, and with ``sparsity`` a global magnitude mask
    ranked there. Returns (spec, params, masks or None, its bucket)."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    t0 = time.time()
    spec = build_model(name)
    hw = FAMILY_HW[spec.patch_size]
    params = to_device(seeded_init(spec), "cuda")
    masks = None
    what = "no mask"
    if sparsity:
        masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                                amount=sparsity)
        kept = sum(int(m.sum()) for m in masks.values())
        total = sum(m.numel() for m in masks.values())
        what = f"{total} prunable weights, sparsity {100 * (1 - kept / total):.2f}%"
    c = spec.cfg
    print(f"{name} {hw[0]}x{hw[1]} ({c.num_layers} layers, D {c.hidden_dim}, {c.num_heads} "
          f"heads of {c.hidden_dim // c.num_heads}, mlp {c.mlp_dim}, patch {c.patch_size}): "
          f"random weights from seed 0, {what} (set-up {time.time() - t0:.1f} s)")
    return spec, params, masks, hw


def family_buckets(hw, patch, seed):
    """An exact-fit and a mixed-size batch of BATCH uint8 images in the
    bucket ``hw`` at ``patch`` (the mixed images 449-512 rows by 321-384
    columns at patch 16 and 32, 449-504 by 337-392 at 14)."""
    rng = np.random.default_rng(seed)
    exact = [hw] * BATCH
    mixed = [hw] * 8 + [(int(rng.integers(449, hw[0] + 1)),
                         int(rng.integers(hw[1] - 55, hw[1] + 1))) for _ in range(BATCH - 8)]
    return {"exact": (make_images(rng, exact, patch), exact),
            "mixed": (make_images(rng, mixed, patch), mixed)}


def check_outs(tag, outs, grid):
    """Boxes inside the grid, seeds on it; prints the background share and
    the mean box area."""
    for key, (box, seed, bg) in outs.items():
        box, seed, bg = box.cpu(), seed.cpu(), bg.cpu()
        gh, gw = grid
        assert box.shape == (BATCH, 4) and seed.shape == (BATCH,) and bg.shape == (BATCH,)
        assert bool(((box[:, 0] <= box[:, 1]) & (box[:, 1] <= gh)
                     & (box[:, 2] <= box[:, 3]) & (box[:, 3] <= gw)).all())
        assert bool(((seed >= 0) & (seed < gh * gw)).all())
        area = float(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).float().mean())
        print(f"{tag} pipeline {list(key)} boxes ok, seed in background {int(bg.sum())}/{BATCH}, "
              f"mean box area {area:.1f} patches")


def family_launches(fa, fm, at):
    """The launch counts a family forward can show."""
    got = {f"flash[{k}]": n for k, n in fa.LAUNCHES.items()}
    got.update({f"fused_mlp[D={d}]": n for d, n in fm.WIDTH_LAUNCHES.items()})
    got["other"] = (sum(fa.PACKED_LAUNCHES.values()) + sum(fa.BWD_LAUNCHES.values())
                    + sum(at.LAUNCHES.values()))
    return got


def family_pipelines(tag, spec, params, masks, hw, dtypes, counters, want, seed):
    """The batched pipeline of one family model on its exact-fit and mixed
    buckets in each of ``dtypes``: launches of the counted forwards against
    ``want`` (every other count 0), sane boxes. Returns (extractors,
    buckets, inputs, pipes, outs, launches)."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    patch = spec.patch_size
    buckets = family_buckets(hw, patch, seed)
    extractors = {e: LostFeatureExtractor(spec, params, masks, compute_dtype=dt)
                  for e, dt in (("f32", None), ("bf16", torch.bfloat16)) if e in dtypes}
    inputs = {(e, b): extractors[e].prepare_batch(imgs, patch, exact_hw=bhw)
              for e in extractors for b, (imgs, bhw) in buckets.items()}
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    torch.cuda.synchronize()
    reset_counts(*counters)
    outs = {key: pipes[key[0]](*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    got = family_launches(fa, fm, at)
    print(f"{tag} LOST path launches ({len(outs)} forwards, "
          f"T = {(hw[0] // patch) * (hw[1] // patch) + 1}): "
          f"{ {k: n for k, n in got.items() if n} }")
    assert got == {k: want.get(k, 0) for k in got}, (got, want)
    check_outs(tag, outs, (hw[0] // patch, hw[1] // patch))
    return extractors, buckets, inputs, pipes, outs, got


def family_cli(card, counters, spec, params, masks):
    """``vipers_torch.cli.main lost --model vit_b_16 --patch-size 16 --dtype
    bf16`` on N_JPEG fixture JPEGs (phase 6's tree) from the pruned ViT-B/16
    written as a reference .pth (weight_orig / weight_mask): 12 flash and 12
    fused-MLP launches (D = 768) a batch, the first batch's boxes equal to
    the pipeline's, preds.pkl one entry an image not reported in the
    background, the results txt equal to ``corloc`` re-scoring; e2e img/s."""
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.data import native
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    if not native.available() and not native.pil_available():
        print("vit_b_16 JPEG LOST: neither libjpeg nor PIL on the host: skipped")
        return None
    root = tempfile.mkdtemp(prefix="vipers_torch_vit_b_16_")
    try:
        data = os.path.join(root, "VOC2007")
        items = voc_tree(data, N_JPEG, seed=3)
        pth = os.path.join(root, "vit_b_16_pruned.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), pth)
        batches = cli_batches(items)
        out = os.path.join(root, "out")
        torch.cuda.synchronize()
        reset_counts(*counters)
        cli(["lost", "--model", "vit_b_16", "--arch", "vit", "--patch-size", "16",
             "--dataset", "VOC07", "--set", "trainval", "--data-path", data,
             "--checkpoint", pth, "--dtype", "bf16", "--batch-size", str(BATCH),
             "--workers", "8", "--output-dir", out])
        torch.cuda.synchronize()
        run = dict(drv.LAST_RUN)
        got = family_launches(fa, fm, at)
        layers = spec.cfg.num_layers
        want = {"flash[bfloat16]": layers * batches, "fused_mlp[D=768]": layers * batches}
        print(f"vit_b_16 JPEG LOST [bf16] {N_JPEG} images, {batches} batches of {BATCH}: "
              f"launches { {k: n for k, n in got.items() if n} }")
        assert got == {k: want.get(k, 0) for k in got}, (got, want)
        assert run["images"] == N_JPEG and run["batches"] == batches, run
        check_first_batch("vit_b_16 bf16", pth, data, items, out, run["failed"], "bf16",
                          model="vit_b_16")
        rescored, txt = check_cli_outputs("vit_b_16", out, data, "trainval", items,
                                          run["failed"])
        ips = N_JPEG / run["decode_to_preds_seconds"]
        print(f"vit_b_16 JPEG LOST [bf16] e2e {ips:.1f} img/s ({N_JPEG} images, first decode "
              f"to preds.pkl {run['decode_to_preds_seconds']:.3f} s; {run['seconds']:.3f} s "
              f"with the model load); seed in background {len(run['failed'])}; re-scored "
              f"{rescored}, results txt {txt.strip()}; decoder {run['decoder']} ({card})")
        return {**got, "batches": batches, "e2e_img_per_s": ips}
    finally:
        remove_later(root)


def family_phase(card, counters, lost_core):
    """The ViT family on the LOST path, full width, random weights from seed
    0, each model's counts set to 0 just before its counted forwards:
    ViT-B/16 (full depth, 50% global magnitude mask) f32 and bf16 on both
    buckets (12 flash and 12 fused-MLP launches at D = 768 a bf16 batch),
    card vs CPU, img/s and p50, then the CLI from JPEGs; vit_b_32 bf16 at
    patch 32 (T = 193: the key-masked einsum, 0 flash and 12 fused-MLP
    launches a batch); vit_l_16 bf16 (24 flash, 24 fused MLP at D = 1024);
    vit_h_14 at 504x392 f32 and bf16 (32 hd-80 flash launches a batch, 32
    fused MLP at D = 1280 in bf16), img/s and the f32 call time, card vs
    CPU at a cut depth. Returns the launches of the family's kernel rows."""
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    rows = {}
    # ViT-B/16, the paper's pruned ViT
    spec, params, masks, hw = family_model("vit_b_16", SPARSITY)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, outs, got = family_pipelines(
        "vit_b_16", spec, params, masks, hw, ("f32", "bf16"), counters,
        {"flash[float32]": 2 * n, "flash[bfloat16]": 2 * n, "fused_mlp[D=768]": 2 * n}, seed=5)
    print(f"vit_b_16 a bf16 batch: {got['flash[bfloat16]'] // 2} flash and "
          f"{got['fused_mlp[D=768]'] // 2} fused-MLP launches at D = 768 (instance "
          f"{fused_mlp_design(fm, 768)})")
    rows["fused_ln_fc1_gelu[bf16, D=768]"] = got["fused_mlp[D=768]"]
    agree = {b: float((outs["f32", b][0] == outs["bf16", b][0]).all(dim=1).float().mean())
             for b in buckets}
    print(f"vit_b_16 bf16 vs f32 on the card: boxes equal on {agree}")
    for e, b in (("f32", "exact"), ("f32", "mixed"), ("bf16", "exact")):
        ex = extractors[e]
        compare_with_cpu(f"vit_b_16 {e}, {b}", spec, params, masks, ex.compute_dtype, ex,
                         *buckets[b], lost_core, n_cpu=2)
    for e, ex in extractors.items():
        imgs, bhw = buckets["exact"]
        ips, p50 = throughput(pipes[e], inputs[e, "exact"],
                              ex.prepare_batch(imgs[:1], PATCH, exact_hw=bhw[:1]))
        print(f"vit_b_16 throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{p50:.2f} ms at B=1 ({card})")
    del extractors, inputs, pipes, outs
    torch.cuda.empty_cache()
    cli_run = family_cli(card, counters, spec, params, masks)
    del params, masks
    torch.cuda.empty_cache()

    # vit_b_32: T = 193 stays below the flash threshold
    spec, params, _, hw = family_model("vit_b_32", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_b_32", spec, params, None, hw, ("bf16",), counters,
        {"fused_mlp[D=768]": 2 * n}, seed=6)
    assert (hw[0] // 32) * (hw[1] // 32) + 1 < fa.flash_min_t()
    print(f"vit_b_32 a bf16 batch: {got['flash[bfloat16]'] // 2} flash and "
          f"{got['fused_mlp[D=768]'] // 2} fused-MLP launches at D = 768")
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], 32, exact_hw=bhw[:1]))
    print(f"vit_b_32 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    del extractors, inputs, pipes, params
    torch.cuda.empty_cache()

    # vit_l_16: the fused MLP's D = 1024
    spec, params, _, hw = family_model("vit_l_16", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_l_16", spec, params, None, hw, ("bf16",), counters,
        {"flash[bfloat16]": 2 * n, "fused_mlp[D=1024]": 2 * n}, seed=7)
    rows["fused_ln_fc1_gelu[bf16, D=1024]"] = got["fused_mlp[D=1024]"]
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], PATCH, exact_hw=bhw[:1]))
    print(f"vit_l_16 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    del extractors, inputs, pipes, params
    torch.cuda.empty_cache()

    # vit_h_14: 16 heads of 80 at 504x392 (T = 1009 -> 1024)
    spec, params, _, hw = family_model("vit_h_14", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_h_14", spec, params, None, hw, ("f32", "bf16"), counters,
        {"flash[float32[hd80]]": 2 * n, "flash[bfloat16[hd80]]": 2 * n,
         "fused_mlp[D=1280]": 2 * n}, seed=8)
    print(f"vit_h_14 a batch: {got['flash[bfloat16[hd80]]'] // 2} hd-80 flash launches (bf16; "
          f"{got['flash[float32[hd80]]'] // 2} in f32) and {got['fused_mlp[D=1280]'] // 2} "
          f"fused-MLP launches at D = 1280 (bf16; instance {fused_mlp_design(fm, 1280)})")
    rows["flash_attention_fwd[bf16, hd80]"] = got["flash[bfloat16[hd80]]"]
    rows["flash_attention_fwd[f32, hd80]"] = got["flash[float32[hd80]]"]
    rows["fused_ln_fc1_gelu[bf16, D=1280]"] = got["fused_mlp[D=1280]"]
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], 14, exact_hw=bhw[:1]))
    print(f"vit_h_14 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    t0 = time.perf_counter()  # warm: family_pipelines ran this batch
    pipes["f32"](*inputs["f32", "exact"])[0].cpu()
    f32_s = time.perf_counter() - t0
    print(f"vit_h_14 [f32] one call at B={BATCH}: {1e3 * f32_s:.1f} ms "
          f"({BATCH / f32_s:.1f} img/s) ({card})")
    del extractors, inputs, pipes
    torch.cuda.empty_cache()
    # card vs CPU on the first VIT_H_CPU_LAYERS blocks of the same weights
    from vipers_torch.discovery.driver import LostFeatureExtractor

    cut, cut_params, _ = cut_model(spec, params, {}, VIT_H_CPU_LAYERS)
    print(f"vit_h_14 card vs CPU: cut to its first {VIT_H_CPU_LAYERS} of {n} blocks and "
          f"B={VIT_H_CPU_BATCH} (the CPU's time), f32")
    ex = LostFeatureExtractor(cut, cut_params, None)
    for b in ("exact", "mixed"):
        imgs, bhw = buckets[b]
        sub = (imgs[8:8 + VIT_H_CPU_BATCH], bhw[8:8 + VIT_H_CPU_BATCH]) if b == "mixed" else \
            (imgs[:VIT_H_CPU_BATCH], bhw[:VIT_H_CPU_BATCH])
        compare_with_cpu(f"vit_h_14 f32, {b}", cut, cut_params, None, torch.float32, ex, *sub,
                         lost_core, n_cpu=VIT_H_CPU_BATCH)
    del ex, params, cut_params
    torch.cuda.empty_cache()
    return rows, cli_run


def voc_tree(root, n, seed):
    """A VOC07-layout tree of ``n`` images under ``root`` from the committed
    fixture: ``JPEGImages/`` as symlinks to fixture JPEGs drawn from
    ``seed``, ``Annotations/`` and ``ImageSets/Main/trainval.txt`` written as
    text (no PIL needed). Returns [(name, (w, h))] in dataset order."""
    import xml.etree.ElementTree as ET

    fixture = os.path.join(REPO, "tests", "data", "torch_voc")
    stems = sorted(f[:-4] for f in os.listdir(os.path.join(fixture, "JPEGImages")))
    xml = {s_: open(os.path.join(fixture, "Annotations", f"{s_}.xml")).read() for s_ in stems}
    dims = {s_: (int(ET.fromstring(x).find("size/width").text),
                 int(ET.fromstring(x).find("size/height").text)) for s_, x in xml.items()}
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    picks = np.random.default_rng(seed).integers(0, len(stems), n)
    items = []
    for i, k in enumerate(picks):
        name, stem = f"{i:06d}", stems[k]
        os.symlink(os.path.join(fixture, "JPEGImages", f"{stem}.jpg"),
                   os.path.join(root, "JPEGImages", f"{name}.jpg"))
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(xml[stem].replace(f"{stem}.jpg", f"{name}.jpg"))
        items.append((name, dims[stem]))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name, _ in items))
    return items


def bucket_of(w, h):
    """The driver's bucket for a w x h image (tier-1 pad, then 4 patches)."""
    from vipers_torch.data.preprocess import bucket_hw

    return bucket_hw(-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, PATCH, 4)


def first_batch(items, batch):
    """The images of the driver's first batch: the first bucket to fill up
    in dataset order, else the smallest bucket key at the end."""
    buffers = {}
    for name, (w, h) in items:
        key = bucket_of(w, h)
        buffers.setdefault(key, []).append(name)
        if len(buffers[key]) == batch:
            return buffers[key]
    return buffers[sorted(buffers)[0]]


def cli_batches(items):
    """The driver's batch count for ``items``: BATCH images a batch in each
    bucket, tail batches included."""
    counts = {}
    for _, (w, h) in items:
        counts[bucket_of(w, h)] = counts.get(bucket_of(w, h), 0) + 1
    return sum(-(-c // BATCH) for c in counts.values())


def check_cli_outputs(tag, out, data, set_name, items, failed):
    """A ``vipers_torch lost`` run's files: preds.pkl one finite box an
    image not reported in the background, the results txt equal to
    ``vipers_torch corloc`` re-scoring. Returns (re-scored line, txt)."""
    import contextlib
    import io
    import pickle

    from vipers_torch.cli.main import main as cli

    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    assert sorted(preds) == sorted({f"{nm}.jpg" for nm, _ in items} - set(failed)), tag
    assert all(len(b) == 4 and all(np.isfinite(b)) for b in preds.values())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["corloc", "--preds", os.path.join(out, "preds.pkl"), "--dataset", "VOC07",
             "--set", set_name, "--data-path", data])
    rescored = [ln for ln in buf.getvalue().splitlines() if ln.startswith("corloc:")]
    with open(os.path.join(out, "results_iteration_00.txt")) as f:
        txt = f.read()
    assert len(rescored) == 1 and txt == f"corloc,{float(rescored[0].split()[1]):.1f},,\n", \
        (txt, rescored)
    return rescored[0], txt


def jpeg_lost_phase(card, counters):
    """``vipers_torch lost`` from JPEGs to CorLoc, in this process: a
    full-width ViT-S/16 (seed 0, 224x224 pos table, 50% global magnitude
    mask) written as a reference .pth, pruned layers as weight_orig /
    weight_mask; runs at B=128, 8 decode threads: bf16 on 1024 images, f32
    on 256, bf16 on 256 under VIPERS_PACKED_ATTENTION=1. Checks preds.pkl
    (one entry per image not reported as a seed-in-background failure), the
    results txt against ``vipers_torch corloc``, 12 attention and (bf16) 12
    fused-MLP launches per batch, and the first batch's boxes against
    ``make_batched_pipeline`` on the same decoded uint8 batch. Prints e2e
    img/s (first decode to preds.pkl), the decode-only rate of the thread
    pool (and of one thread), the CPU count and the decoder. Returns each
    run's launches."""
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.data.detection import DiscoveryDataset
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune

    if not native.available():
        # only a missing libjpeg lets the phase go on (with PIL) or skip
        err = native.build_error() or ""
        why = [ln for ln in err.splitlines()
               if any(k in ln for k in ("jpeglib.h", "-ljpeg", "libjpeg.so"))]
        if not why:
            raise RuntimeError(f"the JPEG decoder did not build: {err}")
        why = why[0]
        if not native.pil_available():
            print(f"JPEG -> boxes -> CorLoc: no libjpeg ({why}) and no PIL: phase skipped")
            return None
        print(f"JPEG -> boxes -> CorLoc: no libjpeg ({why}); decoding with PIL")
    root = tempfile.mkdtemp(prefix="vipers_torch_voc_")
    try:
        items = voc_tree(os.path.join(root, "VOC2007"), N_JPEG, seed=3)
        data = os.path.join(root, "VOC2007")
        with open(os.path.join(data, "ImageSets", "Main", "first256.txt"), "w") as f:
            f.write("".join(f"{name}\n" for name, _ in items[:N_JPEG_SHORT]))
        spec = build_model("vit_s_16")
        params, masks = seeded_pruned(spec)
        pth = os.path.join(root, "vit_s_16_pruned.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), pth)

        ds = DiscoveryDataset("VOC07", "trainval", data)
        for workers in (1, 8):  # 8: the runs' pool; 1: what a thread does alone
            t0 = time.perf_counter()
            n_dec = sum(1 for _ in drv._prefetch_decoded(ds, PATCH, False, workers=workers,
                                                          as_uint8=True))
            dec_ips = n_dec / (time.perf_counter() - t0)
            print(f"decode only: {n_dec} JPEGs with their GT in {n_dec / dec_ips:.3f} s, "
                  f"{dec_ips:.1f} img/s on {workers} thread(s); os.cpu_count() "
                  f"{os.cpu_count()}; decoder {native.backend()}")

        runs = {}
        layers = spec.cfg.num_layers
        for tag, dtype, set_name, n, packed in (("bf16", "bf16", "trainval", N_JPEG, False),
                                                ("f32", "f32", "first256", N_JPEG_SHORT, False),
                                                ("bf16 packed", "bf16", "first256",
                                                 N_JPEG_SHORT, True)):
            out = os.path.join(root, tag.replace(" ", "_"))
            run_items = items[:n]
            batches = cli_batches(run_items)
            if packed:
                os.environ["VIPERS_PACKED_ATTENTION"] = "1"
            try:
                torch.cuda.synchronize()
                reset_counts(*counters)
                cli(["lost", "--model", "vit_s_16", "--arch", "vit", "--dataset", "VOC07",
                     "--set", set_name, "--data-path", data, "--checkpoint", pth,
                     "--dtype", dtype, "--batch-size", str(BATCH), "--workers", "8",
                     "--output-dir", out, "--device", "cuda"])
                torch.cuda.synchronize()
                run = dict(drv.LAST_RUN)
                got = {"flash": fa.LAUNCHES["float32" if dtype == "f32" else "bfloat16"],
                       "packed": fa.PACKED_LAUNCHES["bfloat16"],
                       "fused_mlp": fm.LAUNCHES["bfloat16"],
                       "other": (sum(at.LAUNCHES.values()) + sum(fa.BWD_LAUNCHES.values())
                                 + fa.LAUNCHES["bfloat16" if dtype == "f32" else "float32"]
                                 + fa.PACKED_LAUNCHES["float32"])}
                want = {"flash": 0 if packed else layers * batches,
                        "packed": layers * batches if packed else 0,
                        "fused_mlp": layers * batches if dtype == "bf16" else 0, "other": 0}
                print(f"JPEG LOST [{tag}] {n} images, {batches} batches of {BATCH}: launches "
                      f"{got}")
                assert got == want, (got, want)
                assert run["images"] == n and run["batches"] == batches, (run, n, batches)
                check_first_batch(tag, pth, data, run_items, out, run["failed"], dtype)
            finally:
                if packed:
                    del os.environ["VIPERS_PACKED_ATTENTION"]
            rescored, txt = check_cli_outputs(tag, out, data, set_name, run_items,
                                              run["failed"])
            ips = n / run["decode_to_preds_seconds"]
            print(f"JPEG LOST [{tag}] e2e {ips:.1f} img/s ({n} images, first decode to "
                  f"preds.pkl {run['decode_to_preds_seconds']:.3f} s; {run['seconds']:.3f} s "
                  f"with the model load); seed in background {len(run['failed'])}; re-scored "
                  f"{rescored}, results txt {txt.strip()}; decode only {dec_ips:.1f} img/s; "
                  f"{os.cpu_count()} CPUs; decoder {run['decoder']} ({card})")
            runs[tag] = {**got, "batches": batches, "e2e_img_per_s": ips}
        return runs
    finally:
        remove_later(root)


def check_first_batch(tag, pth, data, items, out, failed, dtype, model="vit_s_16"):
    """The boxes of the run's first batch against ``make_batched_pipeline``
    on the same decoded uint8 batch, with the model loaded as the CLI loads
    it: equal wherever the seed is not in the background."""
    import pickle

    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import box_feat_to_image

    names = first_batch(items, BATCH)
    spec = build_model(model)  # 1000 classes at 224x224, as the checkpoint
    params, _, masks, _ = load_lost_checkpoint(pth, spec)
    ex = LostFeatureExtractor(spec, params, masks, device="cuda",
                              compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
    dec = [native.decode_pad(os.path.join(data, "JPEGImages", f"{n}.jpg"), PATCH) for n in names]
    imgs = [d[0] for d in dec] + [dec[-1][0]] * (BATCH - len(dec))
    hw = [d[1] for d in dec] + [dec[-1][1]] * (BATCH - len(dec))
    box, _seed, bg = (z.cpu().numpy() for z in
                      ex.make_batched_pipeline(K_PATCHES)(*ex.prepare_batch(imgs, PATCH,
                                                                            exact_hw=hw)))
    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    same = 0
    for i, n in enumerate(names):
        im = f"{n}.jpg"
        assert bool(bg[i]) == (im in failed), (tag, im)
        if not bg[i]:
            want = box_feat_to_image(box[i], [PATCH, PATCH], (3, *hw[i])).tolist()
            assert preds[im] == want, (tag, im, preds[im], want)
            same += 1
    print(f"JPEG LOST [{tag}] first batch ({len(names)} images): {same} boxes equal to "
          f"make_batched_pipeline's on the same uint8 batch, {len(names) - same} seeds in "
          f"the background")


def tools_phase(counters):
    """The A/B tools' ``main()`` at their shapes, each with the launch
    counts set to 0 just before it and read just after."""
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.ops import splash_attention as sa
    from vipers_torch.tools import bench_fused_mlp, bench_softmax_prec, bench_splash

    reset_counts(*counters)
    bench_softmax_prec.main([])
    torch.cuda.synchronize()
    launches = {f"attention_train_{k[:3]}[{k[4:-1]}]": n for k, n in at.LAUNCHES.items()
                if "[" in k and "[hd" not in k}  # the softmax variants
    reset_counts(*counters)
    bench_splash.main([])
    torch.cuda.synchronize()
    launches.update({f"splash_attention[{k}]": n for k, n in sa.LAUNCHES.items()})
    reset_counts(*counters)
    bench_fused_mlp.main([])
    torch.cuda.synchronize()
    launches["bench_fused_mlp: fused_ln_fc1_gelu[bf16]"] = fm.LAUNCHES["bfloat16"]
    print(f"A/B tools' launches: {launches}")
    assert all(launches.values()), launches
    return launches


def train_launches(at, fa, fm):
    """The launch counts a train step can show, by kernel row (each head
    dim's instances their own rows)."""
    got = {"fused_ln_fc1_gelu[bf16]": fm.LAUNCHES["bfloat16"]}
    for sfx, hd in (("", 64), (", hd80", 80)):
        got[f"attention_train_fwd[bf16{sfx}]"] = at.LAUNCHES[at._launch_key("fwd", "f32", hd)]
        got[f"attention_train_bwd[bf16{sfx}]"] = at.LAUNCHES[at._launch_key("bwd", "f32", hd)]
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            key = fa.launch_key(dt, hd)
            got[f"flash_attention_fwd[{name}{sfx}]"] = fa.LAUNCHES[key]
            got[f"flash_attention_bwd[{name}{sfx}]"] = fa.BWD_LAUNCHES[key]
    return got


def cut_model(spec, params, masks, layers):
    """``spec`` cut to its first ``layers`` blocks at full width, with the
    same weights and masks (as phase 10 cuts vit_h_14 for the CPU)."""
    import dataclasses

    from vipers_torch.models.vit import _build

    def keep(k):
        return not k.startswith("encoder_layer_") or int(k.rsplit("_", 1)[1]) < layers

    cut = _build(spec.name, dataclasses.replace(spec.cfg, num_layers=layers), spec.input_size)
    return (cut, {k: v for k, v in params.items() if keep(k)},
            {p: m for p, m in masks.items() if keep(p[0])})


def train_phase(card, counters, hw, n_cpu, lrr, model="vit_s_16", patch=PATCH,
                batch=TRAIN_BATCH, cpu_layers=None):
    """The masked train step of full-width ViT-S/16 at hw x hw (12 layers,
    D=384, 6 heads, mlp 1536, 1000 classes; or ``model`` at ``patch``, B =
    ``batch``) with 50% global magnitude masks (ranked on the card) on
    unbaked f32 masters, SGD momentum 0.9, wd 1e-4, lr 0.1 cosine, uint8
    images normalized on the card. At 224 (T = 197 seq-padded to 256) every
    block's attention goes through the training kernels; at 384 (T = 577,
    at least ``flash_min_t()``, seq-padded to 640) through the flash forward
    and backward kernels (vit_h_14: T = 257 -> 384 at 224, 785 -> 896 at
    392, the hd-80 instances). Checks: launches per bf16 step (one of the
    route's forward and one of its backward a block, none of the other
    route's, no fused MLP), finite losses, pruned slots unchanged; img/s at
    B=128 (best of 3 windows of 6 steps) and the peak device memory; card
    vs CPU at B=n_cpu (on the first ``cpu_layers`` blocks, where given):
    f32 params after 2 steps within 1e-4 (counted too: the f32 kernels'
    launches), bf16 loss within 2e-2 and gradients within 3e-2; with
    ``lrr``, one LRR round. Returns the launch counts of the counted bf16
    steps, with the f32 flash backward's from the f32 card steps."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train.loop import magnitude_pruning_round, reset_for_round
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import (create_train_state, loss_and_grads,
                                          make_eval_step, make_train_step)

    t0 = time.time()
    b = batch
    spec = build_model(model, num_classes=1000, image_size=(hw, hw))
    params = to_device(seeded_init(spec), "cuda")
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), SPARSITY)
    ocfg = OptimConfig(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4, epochs=10,
                       lr_scheduler="cosineannealinglr")
    state = create_train_state(spec, params, masks, ocfg, steps_per_epoch=100)
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (b,))).cuda()
    normalize = make_device_normalize()
    x = normalize(u8)
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    pruned = {k: state.params[k].detach()[~m].clone() for k, m in state.masks.items()}
    tokens = (hw // patch) ** 2 + 1
    flash = tokens >= fa.flash_min_t()
    hd = spec.cfg.hidden_dim // spec.cfg.num_heads
    sfx = "" if hd == 64 else f", hd{hd}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"train {model} {hw}x{hw} bf16 B={b} (T={tokens}, hd {hd}, "
          f"{'flash' if flash else 'training'} attention kernels): set-up "
          f"{time.time() - t0:.1f} s")

    # the counted steps
    n_steps = 3
    reset_counts(*counters)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, (x, labels))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = train_launches(at, fa, fm)
    losses = [float(v) for v in losses]
    n = spec.cfg.num_layers * n_steps
    print(f"train steps {hw}x{hw}: losses {losses}; launches in {n_steps} steps {launches}")
    route = ((f"flash_attention_fwd[bf16{sfx}]", f"flash_attention_bwd[bf16{sfx}]") if flash
             else (f"attention_train_fwd[bf16{sfx}]", f"attention_train_bwd[bf16{sfx}]"))
    assert launches == {k: n if k in route else 0 for k in launches}, launches
    assert all(np.isfinite(losses)), losses
    for k, m in state.masks.items():
        assert torch.equal(state.params[k].detach()[~m], pruned[k]), k

    # img/s, bench.py's scheme: best of 3 windows of 6 steps
    best = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(6):
            state, m = step(state, (x, labels))
        torch.cuda.synchronize()
        best = max(best, b * 6 / (time.perf_counter() - t1))
    print(f"train throughput {model} {hw}x{hw} bf16 {best:.1f} img/s at B={b} ({card}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # card vs CPU at B=n_cpu (on a cut depth); the f32 card steps counted
    t_cpu = time.time()
    xs, ys = u8[:n_cpu], labels[:n_cpu]
    cspec, cparams, cmasks = spec, params, masks
    if cpu_layers:
        cspec, cparams, cmasks = cut_model(spec, params, masks, cpu_layers)
        print(f"{model} card vs CPU {hw}x{hw}: cut to its first {cpu_layers} of "
              f"{spec.cfg.num_layers} blocks and B={n_cpu} (the CPU's time)")
    f32 = {}
    for dev in ("cuda", "cpu"):
        st = create_train_state(cspec, cparams, cmasks, ocfg, 100, device=dev)
        st_step = make_train_step(1000)
        batch = (normalize(xs.to(dev)), ys.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts(*counters)
        t2 = time.time()
        for _ in range(2):
            st, _ = st_step(st, batch)
        cpu_s = {"f32": time.time() - t2}
        f32[dev] = {k: p.detach().cpu() for k, p in st.params.items()}
        if dev == "cuda":
            f32_launches = train_launches(at, fa, fm)
            bf = loss_and_grads(st.model, st.masks, batch, 1000, compute_dtype=torch.bfloat16)
            bf_masks, bf_state = st.masks, {k: p.detach().cpu() for k, p in st.params.items()}
    print(f"train f32 {hw}x{hw} B={n_cpu} on the card: launches in 2 steps {f32_launches}")
    if flash:
        n2 = 2 * cspec.cfg.num_layers
        assert f32_launches[f"flash_attention_fwd[f32{sfx}]"] == n2, f32_launches
        assert f32_launches[f"flash_attention_bwd[f32{sfx}]"] == n2, f32_launches
        launches[f"flash_attention_bwd[f32{sfx}]"] = f32_launches[f"flash_attention_bwd[f32{sfx}]"]
    f32_err = max((f32["cuda"][k] - f32["cpu"][k]).abs().max().item() for k in f32["cpu"])
    print(f"cpu-vs-card train {hw}x{hw} f32: params after 2 steps max_abs_err {f32_err:.3e} "
          f"(atol 1e-4)")
    assert f32_err <= 1e-4, f32_err
    cpu_model = cspec.module()
    cpu_model.load_state_dict(bf_state)
    t2 = time.time()
    cpu_bf = loss_and_grads(cpu_model, {k: m.cpu() for k, m in bf_masks.items()},
                            (normalize(xs.cpu()), ys.cpu()), 1000,
                            compute_dtype=torch.bfloat16)
    cpu_s["bf16"] = time.time() - t2
    loss_gap = abs(float(bf[0]) - float(cpu_bf[0]))
    gg = torch.cat([g.flatten().cpu() for g in bf[2].values()])
    gc = torch.cat([cpu_bf[2][k].flatten() for k in bf[2]])
    g_rel = ((gg - gc).norm() / gc.norm()).item()
    print(f"cpu-vs-card train {hw}x{hw} bf16: loss {float(bf[0]):.5f} vs {float(cpu_bf[0]):.5f} "
          f"(gap {loss_gap:.2e}, tol 2e-2 relative); gradients relative L2 error "
          f"{g_rel:.3e} (tol 3e-2); card vs CPU {time.time() - t_cpu:.1f} s (the CPU's 2 f32 steps "
          f"{cpu_s['f32']:.1f} s, its bf16 gradients {cpu_s['bf16']:.1f} s)")
    assert loss_gap <= 2e-2 * abs(float(cpu_bf[0])), loss_gap
    assert g_rel <= 3e-2, g_rel
    if not lrr:
        return launches

    # one LRR round: reset -> train -> prune 20% more -> bake; then train on
    t1 = time.time()
    eval_step = make_eval_step(1000, compute_dtype=torch.bfloat16)
    loader = [(x, labels)] * 2
    state, acc1, sparsity = magnitude_pruning_round(
        step, eval_step, state, lambda e: loader, lambda: loader[:1], epochs=1,
        pruning_rate=0.2, print_freq=0)
    kept = sum(int(m.sum()) for m in state.masks.values())
    total = sum(m.numel() for m in state.masks.values())
    assert abs(sparsity - 60.0) < 0.01 and abs(100.0 * (1 - kept / total) - 60.0) < 0.01, sparsity
    reset_for_round(state)
    for _ in range(2):
        state, m = step(state, (x, labels))
    torch.cuda.synchronize()
    for k, msk in state.masks.items():
        assert bool((state.params[k].detach()[~msk] == 0).all()), k
    print(f"LRR round: sparsity 50% -> {sparsity:.4f}%, pruned slots exact zeros after 2 "
          f"more steps (loss {float(m['loss']):.4f}), {time.time() - t1:.1f} s")
    return launches


# Phase 11: vit_h_14 pruned and trained at 224x224 (T = 257 -> 384: the
# training kernels) and 392x392 (T = 785 -> 896: the flash kernels), both
# hd 80; SNIP at 392 in f32. B: the largest of 32 and 16 that fits the 224
# step, 16 at 392, 8 for SNIP's f32 forward and backward.
VIT_H_TRAIN = ((224, 32), (392, 16))
VIT_H_SNIP_BATCH = 8
# the train steps' card-vs-CPU cut: the CPU's bf16 reference gradients take
# most of the phase, so fewer blocks than the LOST and SNIP cuts
VIT_H_TRAIN_CPU_LAYERS = 2


def snip_phase(card, counters, hw=392, batch=VIT_H_SNIP_BATCH, target=SPARSITY):
    """SNIP on vit_h_14 at 392x392 in f32 (random weights from seed 0, 1000
    classes, uint8 images from seed 9 normalized on the card): first on its
    first VIT_H_CPU_LAYERS blocks at B=VIT_H_CPU_BATCH, card (the f32 flash
    kernels) against the CPU in f32 (the kernels' plain versions) and in
    f64 (the einsum: the truth, to f32's resolution): saliencies within
    1e-5 of their scale of the CPU's f32; masks at the target sparsity
    (exactly, but for saliencies tied at the threshold); where the card's
    and the CPU's f32 masks differ, both saliencies within twice the
    largest saliency difference of their thresholds (derived: no weight
    farther off can flip, so this cannot fail once the saliencies pass);
    and, binding at the threshold, the yardstick the f32 flash kernels
    are held to (10x nearer exact f32 than cuBLAS TF32): on the weights
    whose f64 saliency lies within 1% of the f64 threshold, the RMS of the
    card's saliency error against f64 at most 0.1 of a TF32 run's (the
    card with attention by the einsum and cuBLAS in TF32), and the card's
    masks wrong against the f64 masks on at most 0.1 as many weights as
    that run's (printed beside: the CPU's f32 and the card's einsum in
    f32, which show what the 3xTF32 kernels add). Then at full depth and B=``batch`` on
    the card, counted: 32 f32 hd-80 flash forward and 32 backward
    launches, no other kernel; the masks at the target sparsity; then 2
    bf16 train steps (the flash route) from those masks: finite losses,
    pruned slots unchanged. Returns the full-depth SNIP's launch counts."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, snip_saliency, snip_threshold
    from vipers_torch.pruning.snip import snip_loss
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    def masks_of(sal):
        thr = snip_threshold(sal, target)
        masks = {p: v > thr for p, v in sal.items()}
        n = sum(v.numel() for v in sal.values())
        pruned = n - sum(int(m.sum()) for m in masks.values())
        ties = sum(int((v == thr).sum()) for v in sal.values())
        k = int(n * target)
        assert k <= pruned <= k + ties - 1, (k, pruned, ties)
        return masks, float(thr), n, pruned, k, ties

    t0 = time.time()
    spec = build_model("vit_h_14", num_classes=1000, image_size=(hw, hw))
    params = to_device(seeded_init(spec), "cuda")
    rng = np.random.default_rng(9)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, hw, hw, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (batch,))).cuda()
    x = make_device_normalize()(u8)

    cut, cparams, _ = cut_model(spec, params, {}, VIT_H_CPU_LAYERS)
    sal = {}
    # name: device, dtype, attention by the einsum, cuBLAS in TF32
    runs = {"cuda": ("cuda", torch.float32, False, False),
            "cpu": ("cpu", torch.float32, False, False),
            "f64": ("cpu", torch.float64, True, False),  # the plain versions take no f64
            "einsum": ("cuda", torch.float32, True, False),
            "tf32": ("cuda", torch.float32, True, True)}
    for name, (dev, dtype, einsum, tf32) in runs.items():
        p = to_device(cparams, dev, dtype)
        xb = (x[:VIT_H_CPU_BATCH].to(dev, dtype), labels[:VIT_H_CPU_BATCH].to(dev))
        with attention_by_einsum(einsum), cublas_tf32(tf32):
            s = snip_saliency(snip_loss(cut, 1000), p, xb,
                              init_masks(p, exclude=cut.prune_exclude))
        sal[name] = {k: v.cpu() for k, v in s.items()}
    got, thr, n, pruned, k, ties = masks_of(sal["cuda"])
    want, cthr, *_ = masks_of(sal["cpu"])
    scale = max(float(v.max()) for v in sal["cpu"].values())
    sal_err = max(float((sal["cuda"][p] - sal["cpu"][p]).abs().max()) for p in sal["cpu"])
    assert sal_err <= 1e-5 * scale, (sal_err, scale)
    # derived: a weight's masks can differ only where both saliencies lie
    # within twice the largest saliency difference of their thresholds (the
    # k-th smallest moves by at most that difference)
    band = 2 * sal_err
    flips, far = 0, 0.0
    for p in want:
        diff = got[p] != want[p]
        if not bool(diff.any()):
            continue
        flips += int(diff.sum())
        dist = torch.maximum((sal["cuda"][p][diff] - thr).abs(), (sal["cpu"][p][diff] - cthr).abs())
        far = max(far, float(dist.max()))
        assert far <= band, (p, far, band)
    # binding: against the f64 truth, on the weights that decide the mask
    truth, t64, *_ = masks_of(sal["f64"])
    others = [r for r in runs if r != "f64"]
    masks = {"cuda": got, "cpu": want,
             **{r: masks_of(sal[r])[0] for r in others if r not in ("cuda", "cpu")}}
    sq, wrong, near_n = dict.fromkeys(others, 0.0), dict.fromkeys(others, 0), 0
    for p, s64 in sal["f64"].items():
        near = (s64 - t64).abs() <= 1e-2 * t64
        near_n += int(near.sum())
        for r in others:
            sq[r] += float(((sal[r][p].double() - s64)[near] ** 2).sum())
            wrong[r] += int((masks[r][p] != truth[p]).sum())
    rms = {r: (v / max(near_n, 1)) ** 0.5 / t64 for r, v in sq.items()}
    print(f"SNIP vit_h_14 {hw}x{hw} f32, card vs CPU on its first {VIT_H_CPU_LAYERS} of "
          f"{spec.cfg.num_layers} blocks at B={VIT_H_CPU_BATCH}: {n} prunable weights, pruned "
          f"{pruned} (k = {k}, {ties} at the threshold {thr:.6e}; the CPU's {cthr:.6e}, f64 "
          f"{t64:.6e}); saliencies max_abs_err {sal_err:.3e}, {sal_err / scale:.2e} of their "
          f"scale {scale:.3e} (tol 1e-5); masks equal but for {flips} weights at the threshold "
          f"(the farthest {far:.2e} from it, {far / thr:.2e} relative; derived bound: twice "
          f"the saliency error, {band:.2e}); against f64, on the {near_n} weights within 1% "
          f"of its threshold, saliency RMS error (of the threshold) and masks wrong: "
          + ", ".join(f"{r} {rms[r]:.3e} {wrong[r]}" for r in others)
          + " (the card = cuda; einsum, tf32: the card with attention by the einsum, cuBLAS "
          f"in f32 and TF32; tol: the card 10x nearer f64 than tf32 on both); "
          f"{time.time() - t0:.1f} s")
    assert rms["cuda"] <= 0.1 * rms["tf32"], rms
    assert wrong["cuda"] <= 0.1 * wrong["tf32"], wrong
    del sal, got, want, truth

    reset_counts(*counters)
    loss_fn = snip_loss(spec, 1000)
    base = init_masks(params, exclude=spec.prune_exclude)
    t1 = time.perf_counter()
    sal = snip_saliency(loss_fn, params, (x, labels), base)
    torch.cuda.synchronize()
    snip_s = time.perf_counter() - t1
    counted = train_launches(at, fa, fm)
    layers = spec.cfg.num_layers
    route = {"flash_attention_fwd[f32, hd80]": layers, "flash_attention_bwd[f32, hd80]": layers}
    assert counted == {k: route.get(k, 0) for k in counted}, counted
    masks, thr, n, pruned, k, ties = masks_of(sal)
    del sal
    print(f"SNIP vit_h_14 {hw}x{hw} f32 B={batch}, full depth on the card: {snip_s:.2f} s for "
          f"the saliencies; launches {counted}; {n} prunable weights, pruned {pruned} "
          f"({100 * pruned / n:.4f}%; k = {k}, {ties} at the threshold) ({card})")

    ocfg = OptimConfig(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4, epochs=10,
                       lr_scheduler="cosineannealinglr")
    state = create_train_state(spec, params, masks, ocfg, steps_per_epoch=100)
    pruned_w = {key: state.params[key].detach()[~m].clone() for key, m in state.masks.items()}
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    losses = []
    for _ in range(2):
        state, m = step(state, (x, labels))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    for key, m in state.masks.items():
        assert torch.equal(state.params[key].detach()[~m], pruned_w[key]), key
    print(f"vit_h_14 from the SNIP masks: 2 bf16 steps at {hw}x{hw} B={batch}, losses {losses}, "
          f"pruned slots unchanged ({time.time() - t0:.1f} s for the SNIP phase)")
    return counted


def vit_h_phase(card, counters):
    """Phase 11: vit_h_14 (32 blocks, D 1280, 16 heads of 80, mlp 5120,
    1000 classes) pruned and trained on the card at full width and depth:
    the bf16 masked train step at 224x224 (T = 257 -> 384: 32 hd-80
    training forward and backward launches a step, one LRR round) and
    392x392 (T = 785 -> 896: 32 hd-80 flash forward and backward a step),
    each card vs CPU on its first VIT_H_TRAIN_CPU_LAYERS blocks at
    B=VIT_H_CPU_BATCH; then SNIP (``snip_phase``). Returns the launches of
    the hd-80 training and backward rows."""
    rows = {}
    for hw, batch in VIT_H_TRAIN:
        tl = train_phase(card, counters, hw, VIT_H_CPU_BATCH, lrr=hw == 224, model="vit_h_14",
                         patch=14, batch=batch, cpu_layers=VIT_H_TRAIN_CPU_LAYERS)
        keys = (("attention_train_fwd[bf16, hd80]", "attention_train_bwd[bf16, hd80]")
                if hw == 224 else ("flash_attention_bwd[bf16, hd80]",))
        rows.update({k: tl[k] for k in keys})
        torch.cuda.empty_cache()
    rows["flash_attention_bwd[f32, hd80]"] = snip_phase(
        card, counters)["flash_attention_bwd[f32, hd80]"]
    torch.cuda.empty_cache()
    return rows


# Phase 12: the pruning entry points through the CLI, ViT-B/16 at full
# width and depth on a synthetic ImageFolder of the fixture JPEGs.
N_TRAIN_IMAGES, N_VAL_IMAGES, N_LOST_IMAGES = 256, 256, 128
CUT_BLOCKS, CUT_BATCH = 2, 8  # the f32 card-vs-CPU cut of the driver


def imagefolder_tree(root, n_train, n_val, seed):
    """``train/`` and ``val/`` ImageFolder splits of 8 classes under
    ``root``: class i holds symlinks to fixture JPEG i (sorted stems), the
    images spread over the classes in an order drawn from ``seed`` (n/8 a
    class, names numbered in that order)."""
    fixture = os.path.join(REPO, "tests", "data", "torch_voc", "JPEGImages")
    jpegs = sorted(os.listdir(fixture))
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        classes = rng.permutation(np.arange(n) % len(jpegs))
        for c in range(len(jpegs)):
            os.makedirs(os.path.join(root, split, f"class_{c}"), exist_ok=True)
        for i, c in enumerate(classes):
            os.symlink(os.path.join(fixture, jpegs[c]),
                       os.path.join(root, split, f"class_{c}", f"{i:06d}.jpg"))


def cli_launches(at, fa, fm):
    """The launch counts the train CLI's path can show: the training kernels
    (rows 7-8), the fused MLP at D = 768 (row 4), the flash forward and
    backward (rows 1, 12-13)."""
    return {"attention_train_fwd[bf16]": at.LAUNCHES[at._launch_key("fwd", "f32", 64)],
            "attention_train_bwd[bf16]": at.LAUNCHES[at._launch_key("bwd", "f32", 64)],
            "fused_ln_fc1_gelu[bf16, D=768]": fm.WIDTH_LAUNCHES[768],
            "flash": sum(fa.LAUNCHES.values()) + sum(fa.BWD_LAUNCHES.values())}


def train_cli(cli, argv, counters, at, fa, fm):
    """One ``vipers_torch`` CLI run on the card with the launch counts set to
    0 just before it and read just after; returns (launches, seconds)."""
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    assert cli(argv) == 0
    torch.cuda.synchronize()
    return cli_launches(at, fa, fm), time.perf_counter() - t0


def check_checkpoint(path, want_sparsity, init=None, model="vit_b_16"):
    """A written .pth: the sparsity of ``compute_sparsity_global`` on the
    loaded weights and masks within 1e-4 (points of %) of ``want_sparsity``,
    the driver's count when the masks were set (training may move a weight
    that was exactly zero then), and every masked layer's raw
    ``weight_orig`` where its mask is 0: zero after LRR, which bakes the
    masks; with ``init`` (SNIP, unbaked: the file keeps the raw slots, as
    the JAX package's does) the initial weight, which the masked optimizer
    never moves. ``model``: a ViT or, read through its family, a CNN.
    Returns that sparsity."""
    from vipers_torch.core.checkpoint import (family, import_vit_torchvision,
                                              load_torch_state_dict)
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import compute_sparsity_global

    raw = torch.load(path, map_location="cpu", weights_only=False)["model"]
    for k, m in raw.items():
        if k.endswith("_mask"):
            base = k[:-len("_mask")]
            kept = m.bool()
            got = raw[base + "_orig"][~kept]
            want = torch.zeros_like(got) if init is None else init[base][~kept]
            assert torch.equal(got, want), (path, base)
    sd = load_torch_state_dict(path)
    if model.startswith("vit"):
        layers = len({k.split(".")[2] for k in sd if k.startswith("encoder.layers.")})
        params, masks = import_vit_torchvision(sd, layers)
    else:
        spec = build_model(model)
        params, _, masks = family(spec).import_pth(sd, spec)
    sparsity = compute_sparsity_global(params, masks)
    assert abs(sparsity - want_sparsity) <= 1e-4, (path, sparsity, want_sparsity)
    return sparsity


def driver_card_vs_cpu(card, root, data):
    """The f32 driver on the card against the CPU: vit_b_16 cut to its first
    CUT_BLOCKS blocks at full width, B = CUT_BATCH, 2 steps an epoch, the
    same seed-0 weights, each device through the driver's own SNIP steps
    (``run_snip`` is ``snip_saliencies``, ``snip_masks``, ``train_snip``)
    and one ``run_magnitude`` iteration (2 steps, prune 20% more, bake).
    SNIP: the card's saliencies within 1e-5 of their scale of the CPU's
    (phase 11's tolerance; a run with cuBLAS in TF32 is shown to miss it),
    and where the masks of the two differ, both saliencies within twice the
    largest saliency difference of their thresholds (derived: the k-th
    smallest moves by at most that difference). Both devices then train the
    CARD's masks (a flipped mask would train a weight on one side only):
    parameters within 1e-4 where both final masks agree, the sparsities
    equal, and each magnitude mask that differs kept on one side at a |w|
    within twice the largest parameter difference of the CPU's smallest kept
    |w| (only a weight that close to the cutoff can change sides)."""
    from vipers_torch.core import registry
    from vipers_torch.core.checkpoint import vit_masks_from_state_dict
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.models.vit import ViTConfig, _build
    from vipers_torch.pruning.snip import snip_threshold
    from vipers_torch.train import driver as tdrv
    from vipers_torch.train.optim import OptimConfig

    name = f"vit_b_16_cut{CUT_BLOCKS}"
    registry._ensure_builtins_imported()
    registry._BUILTIN_MODELS[name] = lambda num_classes=1000, image_size=(224, 224): _build(
        name, ViTConfig(16, CUT_BLOCKS, 12, 768, 3072, num_classes), image_size)
    try:
        params = registry.build_model(name).init(torch.Generator().manual_seed(0))
        res, sal = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            cfg = TrainConfig(model=name, data_path=data, num_classes=1000,
                              batch_size=CUT_BATCH, workers=8, pruning_method="snip",
                              target_sparsity=SPARSITY, pruning_rate=0.2, pruning_threshold=55.0,
                              optim=OptimConfig(lr=0.1, epochs=1), seed=0, print_freq=0,
                              output_dir=os.path.join(root, f"cut_{dev}"), device=dev)
            s = tdrv.build_session(cfg, params=params)
            got = tdrv.snip_saliencies(s)
            sal[dev] = {p: v.cpu() for p, v in got.items()}
            if dev == "cuda":
                with cublas_tf32():
                    sal["tf32"] = {p: v.cpu() for p, v in tdrv.snip_saliencies(s).items()}
                s.state.masks = tdrv.snip_masks(s, got)
                snip = {k: m.cpu() for k, m in s.state.masks.items()}
            else:
                s.state.masks = dict(snip)  # the card's masks
            del got
            tdrv.train_snip(s)
            _, rows = tdrv.run_magnitude(s)
            res[dev] = dict(rows=rows, secs=time.time() - t0,
                            params={k: p.detach().cpu() for k, p in s.state.params.items()},
                            masks={k: m.cpu() for k, m in s.state.masks.items()})
        cpu_sal = sal["cpu"]
        scale = max(float(v.max()) for v in cpu_sal.values())
        cthr = float(snip_threshold(cpu_sal, SPARSITY))
        cpu_masks = {p: v > cthr for p, v in cpu_sal.items()}

        def against_cpu(run, masks):
            """(max saliency error, masks differing from the CPU's, the
            farthest of them from either threshold)"""
            err = max(float((sal[run][p] - v).abs().max()) for p, v in cpu_sal.items())
            thr = float(snip_threshold(sal[run], SPARSITY))
            flips, far = 0, 0.0
            for p, m in masks.items():
                diff = m != cpu_masks[p]
                if bool(diff.any()):
                    flips += int(diff.sum())
                    far = max(far, float(torch.maximum((sal[run][p][diff] - thr).abs(),
                                                       (cpu_sal[p][diff] - cthr).abs()).max()))
            return err, flips, far

        err, snip_flips, far = against_cpu("cuda", vit_masks_from_state_dict(snip))
        band = 2 * err
        t_err, t_flips, t_far = against_cpu(
            "tf32", {p: v > snip_threshold(sal["tf32"], SPARSITY) for p, v in sal["tf32"].items()})
        print(f"train driver f32 SNIP, vit_b_16 cut to its first {CUT_BLOCKS} of 12 blocks, "
              f"B={CUT_BATCH}, the card against the CPU: saliencies max_abs_err {err:.3e}, "
              f"{err / scale:.2e} of their scale {scale:.3e} (tol 1e-5); {snip_flips} masks "
              f"differ, the farthest {far:.2e} from a threshold ({far / cthr:.2e} of the CPU's "
              f"{cthr:.6e}; derived bound twice the error, {band:.2e}, {band / cthr:.2e} of it). "
              f"cuBLAS in TF32 on the card: max_abs_err {t_err:.3e}, {t_err / scale:.2e} of the "
              f"scale (must miss the 1e-5); {t_flips} masks differ, the farthest {t_far:.2e} "
              f"({t_far / cthr:.2e} of the threshold) "
              f"({card})")
        assert err <= 1e-5 * scale, (err, scale)
        assert far <= band, (far, band)
        assert t_err > 1e-5 * scale, (t_err, scale)
        gpu, cpu = res["cuda"], res["cpu"]
        assert len(gpu["rows"]) == len(cpu["rows"]) == 1
        assert gpu["rows"][0][1] == cpu["rows"][0][1], (gpu["rows"], cpu["rows"])
        err, agree = 0.0, {}
        for k, p in cpu["params"].items():
            agree[k] = cpu["masks"][k] == gpu["masks"][k] if k in cpu["masks"] else \
                torch.ones_like(p, dtype=torch.bool)
            err = max(err, float((gpu["params"][k] - p).abs()[agree[k]].max()))
        cutoff = min(float(cpu["params"][k][m].abs().min()) for k, m in cpu["masks"].items())
        mag_flips = 0
        for k, m in cpu["masks"].items():
            diff = ~agree[k]
            mag_flips += int(diff.sum())
            kept = torch.where(m, cpu["params"][k], gpu["params"][k])[diff].abs()
            assert bool(((kept - cutoff).abs() <= 2 * err + 1e-7).all()), k
        n = sum(m.numel() for m in cpu["masks"].values())
        print(f"train driver f32 card vs CPU, the same cut: from the card's SNIP masks "
              f"(train_snip, 2 steps), then one run_magnitude iteration (2 steps, "
              f"{cpu['rows'][0][1]:.4f}% -> 60%): params max_abs_err {err:.3e} (atol 1e-4) "
              f"where the masks agree, magnitude masks differing {mag_flips} of {n}, each kept "
              f"at |w| within {2 * err + 1e-7:.1e} of the cutoff {cutoff:.6f}; the card's "
              f"{gpu['secs']:.1f} s, the CPU's {cpu['secs']:.1f} s ({card})")
        assert err <= 1e-4, err
    finally:
        del registry._BUILTIN_MODELS[name]


def f32_eval_acc1(cfg, ckpts, root):
    """acc1 of each checkpoint by the train driver's own eval in f32: a
    session built from ``cfg`` without ``--amp`` on the card, each
    checkpoint's weights and masks restored by ``resume_session``, its val
    loader and eval step; the yardstick of ``evaluate``, which evaluates in
    f32 whatever ``--amp`` says, as the JAX sweep does."""
    import dataclasses

    from vipers_torch.train import driver as tdrv
    from vipers_torch.train.loop import evaluate

    s = tdrv.build_session(dataclasses.replace(cfg, amp=False, device="cuda",
                                               output_dir=os.path.join(root, "f32_eval")))
    out = []
    for ck in ckpts:
        tdrv.resume_session(s, ck)
        out.append(evaluate(s.eval_step, s.state, tdrv._val_loader(s),
                            normalize_fn=s.normalize, expected_samples=len(s.val_ds))[0])
    del s
    torch.cuda.empty_cache()
    return out


def run_cli_without_kernels(cli, argv, counters):
    """One CLI run on the card, the launch counts set to 0 just before it
    and read just after: none of the port's kernels may launch. Returns its
    seconds."""
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    assert cli(argv) == 0
    torch.cuda.synchronize()
    n = all_launches(counters)
    assert n == 0, (argv[0], n)
    return time.perf_counter() - t0


def train_cli_phase(card, counters, keep_pth=None):
    """Phase 12: ``vipers_torch train`` and ``evaluate`` on ViT-B/16 (12
    blocks, D 768, 12 heads of 64, mlp 3072, 1000 classes, the CLI's seed-42
    weights)
    at 224x224 with ``--amp --batch-size 128 --workers 8`` on an ImageFolder
    of N_TRAIN_IMAGES train and N_VAL_IMAGES val symlinks to the 8 fixture
    JPEGs: SNIP to 50% for one epoch; LRR (rate 0.2, threshold 36) for two
    iterations of one epoch; ``evaluate`` over the LRR checkpoints;
    ``lost`` from the iteration-01 checkpoint on N_LOST_IMAGES of phase 6's
    JPEGs. Checks the first train and val batches against the CPU loader's,
    the launches (12 training forward and backward a step, 12 fused MLP an
    eval batch, no flash), finite bf16 losses, the pruned slots of every
    checkpoint (``check_checkpoint``), performance.txt's sparsities, evaluate's acc1 (f32,
    no fused MLP) against the driver's f32 eval of the same checkpoints
    (``f32_eval_acc1``), preds.pkl; then the f32 driver card vs CPU on a cut
    (``driver_card_vs_cpu``). Prints train e2e img/s (first decode to last
    checkpoint), step img/s (best of 3 windows of 6 steps), decode-only
    img/s on the RRC path (8 threads, 1), evaluate img/s. Returns the
    launches of its CLI runs by kernel row; ``keep_pth`` receives a copy
    of the iteration-01 checkpoint (phase 18 quantizes it)."""
    import dataclasses
    import json
    import pickle
    import shutil
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.core.metrics import MetricsWriter
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.data.imagefolder import ImageFolder, ImageFolderLoader
    from vipers_torch.discovery import driver as ldrv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.train import driver as tdrv

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="vipers_torch_train_cli_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, N_TRAIN_IMAGES, N_VAL_IMAGES, seed=4)
        b = BATCH
        common = ["--model", "vit_b_16", "--num-classes", "1000", "--amp", "--batch-size",
                  str(b), "--workers", "8", "--data-path", data, "--epochs", "1",
                  "--print-freq", "4"]
        cfg = TrainConfig(model="vit_b_16", data_path=data, batch_size=b, workers=8,
                          amp=True, device="cpu")
        steps = N_TRAIN_IMAGES // b
        evals = -(-N_VAL_IMAGES // b)
        layers = build_model("vit_b_16").cfg.num_layers

        # decode only, the train preset (RandomResizedCrop + flip), numpy batches
        ds = ImageFolder(os.path.join(data, "train"))
        for workers, n in ((8, N_TRAIN_IMAGES), (1, 2 * b)):
            loader = tdrv.train_loader(dataclasses.replace(cfg, workers=workers), ds, 0)
            loader = ImageFolderLoader(ds, loader.indices[:n], b, loader.decode_fn,
                                       num_workers=workers, drop_last=True, seed=loader.seed)
            t0 = time.perf_counter()
            got = sum(len(lab) for _, lab in loader)
            secs = time.perf_counter() - t0
            print(f"train CLI decode only (the PIL train preset, RandomResizedCrop 224 + flip; "
                  f"libjpeg {'built' if native.available() else 'absent'}, used only with "
                  f"--native-decode): {got} images in {secs:.3f} s, {got / secs:.1f} img/s on "
                  f"{workers} thread(s); os.cpu_count() {os.cpu_count()} ({card})")

        total = {}

        def add(launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        # 1. SNIP, one epoch
        snip_out = os.path.join(root, "snip")
        got, secs = train_cli(cli, ["train", *common, "--pruning-method", "snip",
                                    "--target-sparsity", str(SPARSITY), "--output-dir", snip_out],
                              counters, at, fa, fm)
        run = dict(tdrv.LAST_RUN)
        want = {"attention_train_fwd[bf16]": layers * steps,
                "attention_train_bwd[bf16]": layers * steps,
                "fused_ln_fc1_gelu[bf16, D=768]": layers * evals, "flash": 0}
        print(f"train CLI [snip] vit_b_16 bf16 B={b}: {steps} steps, {evals} eval batches, "
              f"launches {got}")
        assert got == want, (got, want)
        add(got)
        # the first batches the card's run decoded against the CPU loader's
        for kind, loader in (("train", tdrv.train_loader(cfg, ds, 0)),
                             ("val", tdrv.val_loader(cfg, ImageFolder(os.path.join(data, "val"))))):
            want_i, want_l = next(iter(loader))
            got_i, got_l = run[f"first_{kind}_batch"]
            assert got_i.dtype == np.uint8 and np.array_equal(got_i, want_i), kind
            assert np.array_equal(got_l, want_l), kind
        e2e = steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        with open(os.path.join(snip_out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss = [r["loss"] for r in recs if r["tag"] == "train"]
        assert len(loss) == 1 and np.isfinite(loss[0]), recs
        snip_sp = [r["sparsity"] for r in recs if r["tag"] == "prune"][0]
        init = export_vit_torchvision(build_model("vit_b_16").init(
            torch.Generator().manual_seed(cfg.seed)))
        init = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in init.items()}
        for stem in ("epoch_0", "checkpoint"):
            check_checkpoint(os.path.join(snip_out, f"vit_b_16_{stem}_snip_{SPARSITY}.pth"),
                             snip_sp, init=init)
        del init
        print(f"train CLI [snip] e2e {e2e:.1f} img/s ({steps * b} images, first decode to the "
              f"last checkpoint {run['t_last_checkpoint'] - run['t_first_decode']:.3f} s; "
              f"{secs:.3f} s with the model's set-up); sparsity {snip_sp:.4f}%, train loss "
              f"{loss[0]:.4f}; first train and val batches equal to the CPU loader's ({card})")
        remove_later(snip_out)

        # 2. LRR: two iterations of one epoch
        lrr_out = os.path.join(root, "lrr")
        got, secs = train_cli(cli, ["train", *common, "--pruning-method", "magnitude",
                                    "--pruning-rate", "0.2", "--pruning-threshold", "36",
                                    "--output-dir", lrr_out], counters, at, fa, fm)
        run = dict(tdrv.LAST_RUN)
        want = {k: 2 * v for k, v in want.items()}
        print(f"train CLI [magnitude] 2 iterations: launches {got}")
        assert got == want, (got, want)
        add(got)
        rows = MetricsWriter.read_performance_txt(os.path.join(lrr_out, "performance.txt"))
        assert len(rows) == 2, rows
        for it, (_, sp) in enumerate(rows):
            for stem in ("epoch_0", "checkpoint"):
                check_checkpoint(os.path.join(lrr_out, f"vit_b_16_{stem}_pruning_iteration_"
                                                       f"{it:02d}.pth"), sp)
        e2e_lrr = 2 * steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        print(f"train CLI [magnitude] e2e {e2e_lrr:.1f} img/s ({2 * steps * b} images, "
              f"{run['t_last_checkpoint'] - run['t_first_decode']:.3f} s; {secs:.3f} s with the "
              f"set-up); performance.txt {rows} ({card})")

        # 3. evaluate over the LRR checkpoints: f32 whatever --amp says, as
        # the JAX sweep; no fused MLP (bf16 only)
        ev_out = os.path.join(root, "eval")
        got, secs = train_cli(cli, ["evaluate", *common, "--models-path", lrr_out,
                                    "--output-dir", ev_out], counters, at, fa, fm)
        want = {"attention_train_fwd[bf16]": 0, "attention_train_bwd[bf16]": 0,
                "fused_ln_fc1_gelu[bf16, D=768]": 0, "flash": 0}
        assert got == want, (got, want)
        add(got)
        ev_rows = MetricsWriter.read_performance_txt(os.path.join(ev_out, "performance.txt"))
        ckpts = [os.path.join(lrr_out, f"vit_b_16_epoch_0_pruning_iteration_{it:02d}.pth")
                 for it in range(len(rows))]
        f32 = f32_eval_acc1(cfg, ckpts, root)
        assert [a for a, _ in ev_rows] == f32, (ev_rows, f32)
        assert all(abs(e - t) <= 1e-4 for (_, e), (_, t) in zip(ev_rows, rows)), (ev_rows, rows)
        print(f"evaluate --amp over 2 checkpoints: launches {got}; acc1 and sparsity {ev_rows} "
              f"(acc1 equal to the driver's f32 eval of the same checkpoints {f32}, the "
              f"training run's bf16 epoch-end acc1 {[a for a, _ in rows]}; sparsity within "
              f"1e-4); {2 * N_VAL_IMAGES / secs:.1f} img/s ({2 * N_VAL_IMAGES} images in "
              f"{secs:.3f} s with the model's set-up and 2 checkpoint loads) ({card})")

        # 4. lost from the trained checkpoint
        voc = os.path.join(root, "VOC2007")
        items = voc_tree(voc, N_LOST_IMAGES, seed=3)
        lost_out = os.path.join(root, "lost")
        reset_counts(*counters)
        cli(["lost", "--model", "vit_b_16", "--patch-size", "16", "--dtype", "bf16",
             "--dataset", "VOC07", "--set", "trainval", "--data-path", voc, "--checkpoint",
             os.path.join(lrr_out, "vit_b_16_epoch_0_pruning_iteration_01.pth"),
             "--batch-size", str(b), "--workers", "8", "--output-dir", lost_out])
        torch.cuda.synchronize()
        lrun = dict(ldrv.LAST_RUN)
        with open(os.path.join(lost_out, "preds.pkl"), "rb") as f:
            preds = pickle.load(f)
        assert len(preds) == N_LOST_IMAGES - len(lrun["failed"]) > 0, (len(preds), lrun)
        print(f"lost --checkpoint vit_b_16_epoch_0_pruning_iteration_01.pth: {len(preds)} "
              f"boxes in preds.pkl, {len(lrun['failed'])} seeds in the background, "
              f"{lrun['images'] / lrun['decode_to_preds_seconds']:.1f} img/s e2e ({card})")
        if keep_pth:
            shutil.copyfile(os.path.join(lrr_out, "vit_b_16_epoch_0_pruning_iteration_01.pth"),
                            keep_pth)
        remove_later(lrr_out)

        # step img/s: the CLI's session and batch, best of 3 windows of 6 steps
        s = tdrv.build_session(dataclasses.replace(cfg, device="cuda",
                                                   output_dir=os.path.join(root, "step")))
        images, labels = next(iter(tdrv._train_loader(s, 0)))
        x = s.normalize(images)
        reset_counts(*counters)
        s.train_step(s.state, (x, labels))
        torch.cuda.synchronize()
        one = cli_launches(at, fa, fm)
        assert one == {"attention_train_fwd[bf16]": layers, "attention_train_bwd[bf16]": layers,
                       "fused_ln_fc1_gelu[bf16, D=768]": 0, "flash": 0}, one
        best = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(6):
                s.train_step(s.state, (x, labels))
            torch.cuda.synchronize()
            best = max(best, b * 6 / (time.perf_counter() - t1))
        print(f"train CLI session step vit_b_16 224x224 bf16 {best:.1f} img/s at B={b} "
              f"({one['attention_train_fwd[bf16]']} + {one['attention_train_bwd[bf16]']} "
              f"training attention launches a step; {card})")
        del s, x
        torch.cuda.empty_cache()

        # the f32 driver, card vs CPU, on a cut
        cut = os.path.join(root, "cut")
        imagefolder_tree(cut, 2 * CUT_BATCH, CUT_BATCH, seed=5)
        driver_card_vs_cpu(card, root, cut)
        print(f"phase 12 train CLI launches: {total}; {time.time() - t_phase:.1f} s")
        return total
    finally:
        remove_later(root)


# Phase 13: the CNN families through the pruning and LOST entry points.
CNN_MODEL, CNN_DILATE = "resnet50", 2
CNN_CUT_BATCH = 4  # the f32 card-vs-CPU train run, ResNet-50 at full depth


def all_launches(counters):
    """Every launch the counters hold: the attention and fused-MLP kernels."""
    return sum(v for counts in counters for v in counts.values())


@contextlib.contextmanager
def cudnn_tf32():
    """While on, the port's f32 convolutions take cuDNN's TF32: the
    exact-f32 scope of the train step is switched off."""
    from vipers_torch.models import cnn

    old_scope, old = cnn.exact_f32_convs, torch.backends.cudnn.allow_tf32
    cnn.exact_f32_convs = lambda dtype=torch.float32: contextlib.nullcontext()
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cnn.exact_f32_convs = old_scope
        torch.backends.cudnn.allow_tf32 = old


def cnn_bucket_images(ex, items_hw, rng):
    """Tier-1-padded uint8 images of the given exact (h, w), grouped by the
    extractor's CNN bucket key: {key: (images, exact_hw)}."""
    out = {}
    for img, hw in zip(make_images(rng, items_hw), items_hw):
        key = ex.cnn_bucket_key(*img.shape[:2])
        out.setdefault(key, ([], []))
        out[key][0].append(img)
        out[key][1].append(hw)
    return out


def compare_cnn_with_cpu(tag, spec, params, masks, ex, buckets, lost_core):
    """Each bucket's B images through the card's extractor and the same on
    the CPU: f32 features within 1e-3 of their scale and equal boxes (a
    seed may differ only inside a tie at the top score)."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    cpu = LostFeatureExtractor(spec, params, masks, device="cpu")
    for key, (imgs, hw) in buckets.items():
        gin = ex.prepare_cnn_batch(imgs, key, exact_hw=hw)
        cin = cpu.prepare_cnn_batch(imgs, key, exact_hw=hw)
        gf, cf = ex.cnn_features(*gin).float().cpu(), cpu.cnn_features(*cin)
        gbox, gseed, gbg = (z.cpu() for z in ex.make_batched_cnn_pipeline(K_PATCHES)(*gin))
        cbox, cseed, cbg = cpu.make_batched_cnn_pipeline(K_PATCHES)(*cin)
        scale, ferr = cf.abs().max().item(), (gf - cf).abs().max().item()
        same_seed, same_box = gseed == cseed, (gbox == cbox).all(dim=1)
        n = len(imgs)
        print(f"cpu-vs-card [{tag}, bucket {key}] features max_abs_err {ferr:.3e} (scale "
              f"{scale:.3g}, tol 1e-3 of it); seeds equal {int(same_seed.sum())}/{n}, boxes "
              f"equal {int(same_box.sum())}/{n}")
        assert ferr <= 1e-3 * scale, (ferr, scale)
        grid = (cpu._cnn_fdim(key[0]), cpu._cnn_fdim(key[1]))
        scores = lost_core(cf, cin[1], grid, K_PATCHES)["scores"]
        for i in range(n):
            if same_seed[i]:
                assert same_box[i] and gbg[i] == cbg[i], (i, gbox[i], cbox[i])
            else:
                s = scores[i]
                assert s[gseed[i]] == s[cseed[i]] == s.max(), (i, gseed[i], cseed[i])


def check_first_cnn_batch(tag, pth, data, items, out, failed, model, dilate):
    """The boxes of a CNN run's first batch (the first bucket to fill up,
    else the smallest key) against ``make_batched_cnn_pipeline`` on the same
    decoded uint8 batch, the model loaded as the CLI loads it (bf16)."""
    import pickle

    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import box_feat_to_image

    spec = build_model(model, **({"dilate": dilate} if dilate != 1 else {}))
    params, stats, masks, _ = load_lost_checkpoint(pth, spec)
    if spec.num_classes:
        from vipers_torch.core.checkpoint import infer_num_classes

        spec = build_model(model, num_classes=infer_num_classes(params),
                           **({"dilate": dilate} if dilate != 1 else {}))
    ex = LostFeatureExtractor(spec, params, masks, device="cuda", batch_stats=stats,
                              compute_dtype=torch.bfloat16)
    buffers, names = {}, None
    for name, (w, h) in items:
        key = ex.cnn_bucket_key(-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH)
        buffers.setdefault(key, []).append(name)
        if len(buffers[key]) == BATCH:
            names, key0 = buffers[key], key
            break
    else:
        key0 = sorted(buffers)[0]
        names = buffers[key0]
    dec = [native.decode_pad(os.path.join(data, "JPEGImages", f"{n}.jpg"), PATCH) for n in names]
    imgs = [d[0] for d in dec] + [dec[-1][0]] * (BATCH - len(dec))
    hw = [d[1] for d in dec] + [dec[-1][1]] * (BATCH - len(dec))
    box, _seed, bg = (z.cpu().numpy() for z in ex.make_batched_cnn_pipeline(K_PATCHES)(
        *ex.prepare_cnn_batch(imgs, key0, exact_hw=hw)))
    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    same = 0
    for i, n in enumerate(names):
        im = f"{n}.jpg"
        assert bool(bg[i]) == (im in failed), (tag, im)
        if not bg[i]:
            want = box_feat_to_image(box[i], ex.cnn_scales(*imgs[i].shape[:2]),
                                     (3, *hw[i])).tolist()
            assert preds[im] == want, (tag, im, preds[im], want)
            same += 1
    print(f"CNN LOST [{tag}] first batch ({len(names)} images, bucket {key0}): {same} boxes "
          f"equal to make_batched_cnn_pipeline's on the same uint8 batch, "
          f"{len(names) - same} seeds in the background")


def rel_l2(got, ref, keep=None):
    """||got - ref|| / ||ref|| over every tensor of two dicts (in f64),
    restricted to the elements where ``keep[k]`` (bool) holds, if given."""
    num = den = 0.0
    for k, r in ref.items():
        d, r = got[k].double() - r.double(), r.double()
        if keep is not None and k in keep:
            d, r = d[keep[k]], r[keep[k]]
        num += float((d * d).sum())
        den += float((r * r).sum())
    return (num / den) ** 0.5


def cnn_driver_card_vs_cpu(card, root, data):
    """The f32 driver on ResNet-50 at full depth, B = CNN_CUT_BATCH (2 steps
    an epoch), the same seed-0 weights, on the card (exact f32
    convolutions), on the CPU in f32, on the CPU in f64 (the model cast to
    f64: the reference) and on the card with cuDNN's TF32 convolutions:
    one train forward (the loss and the updated running statistics: card
    vs CPU within 1e-4 of their scale), ``snip_saliencies``, ``snip_masks``
    (the card's masks on every run), ``train_snip`` (2 steps) and one
    ``run_magnitude`` iteration (2 steps, prune 20% more, bake).

    A BatchNorm ResNet's gradients at initialization explode with depth, so
    f32 rounding alone moves them far beyond a 1e-5 tolerance: the CPU's
    own f32 run lies percents (relative L2) from the f64 run, as this
    function prints. The saliencies and the parameters and running
    statistics after each stage are therefore held against the f64 run:
    the card's f32 no farther from it (relative L2) than 2x the CPU's own
    f32, the TF32 run printed beside. Then, at the card's SNIP-trained
    state, one bf16 step's loss (card vs CPU bf16 within 2e-2 relative) and
    gradients (relative L2 from the CPU's f64 gradients no more than 2x the
    CPU bf16's)."""
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.core.registry import build_model
    from vipers_torch.models import cnn
    from vipers_torch.pruning.snip import snip_threshold
    from vipers_torch.train import driver as tdrv
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import forward_params, loss_and_grads, train_loss

    params = build_model(CNN_MODEL).init(torch.Generator().manual_seed(0))
    res, snip = {}, None
    for run in ("cuda", "cpu", "f64", "tf32"):
        dev = "cuda" if run in ("cuda", "tf32") else "cpu"
        t0 = time.time()
        cfg = TrainConfig(model=CNN_MODEL, data_path=data, num_classes=1000,
                          batch_size=CNN_CUT_BATCH, workers=8, pruning_method="snip",
                          target_sparsity=SPARSITY, pruning_rate=0.2, pruning_threshold=55.0,
                          optim=OptimConfig(lr=0.1, epochs=1), seed=0, print_freq=0,
                          output_dir=os.path.join(root, f"cnn_cut_{run}"), device=dev)
        with cudnn_tf32() if run == "tf32" else contextlib.nullcontext():
            s = tdrv.build_session(cfg, params=params)
            if run == "f64":
                s.state.model.to(torch.float64)
            images, labels = next(iter(tdrv._train_loader(s, 0)))
            batch = (s.normalize(images), labels)
            with cnn.exact_f32_convs(), torch.no_grad():
                loss, _, stats = train_loss(s.state.model,
                                            forward_params(s.state.params, {}), batch, 1000)
            fwd = (float(loss), {k: v.cpu() for k, v in stats.items()})
            sal = {p: v.cpu() for p, v in tdrv.snip_saliencies(s).items()}
            if snip is None:
                snip = {k: m.cpu() for k, m in tdrv.snip_masks(s, sal).items()}
            s.state.masks = {k: m.to(s.device) for k, m in snip.items()}
            tdrv.train_snip(s)
            after_snip = {k: v.detach().cpu().clone() for k, v in
                          {**s.state.params, **s.state.batch_stats}.items()}
            _, rows = tdrv.run_magnitude(s)
        res[run] = dict(fwd=fwd, sal=sal, after_snip=after_snip, rows=rows,
                        secs=time.time() - t0, device=s.device,
                        params={k: v.detach().cpu() for k, v in
                                {**s.state.params, **s.state.batch_stats}.items()},
                        masks={k: m.cpu() for k, m in s.state.masks.items()})
        del s
        torch.cuda.empty_cache()
    # one train forward: the loss and the updated running statistics
    (gl, gst), (cl, cst) = res["cuda"]["fwd"], res["cpu"]["fwd"]
    scale = max(float(v.abs().max()) for v in cst.values())
    st_err = max(float((gst[k] - v).abs().max()) for k, v in cst.items())
    print(f"train forward f32, {CNN_MODEL} full depth, B={CNN_CUT_BATCH}, card vs CPU: loss "
          f"{gl:.6f} vs {cl:.6f}, updated running statistics max_abs_err {st_err:.3e} "
          f"({st_err / scale:.2e} of their scale {scale:.3g}, tol 1e-4) ({card})")
    assert st_err <= 1e-4 * scale and abs(gl - cl) <= 1e-4 * abs(cl), (st_err, gl, cl)
    # SNIP, the stages of training: each f32 run's distance from the f64 run
    ref = res["f64"]
    dist = {}
    for stage in ("sal", "after_snip", "params"):
        keep = None
        if stage == "params":  # where every run's magnitude masks agree
            keep = {k: (m == res["cuda"]["masks"][k]) & (m == res["cpu"]["masks"][k])
                    & (m == res["tf32"]["masks"][k]) for k, m in ref["masks"].items()}
        dist[stage] = {run: rel_l2(res[run][stage], ref[stage], keep)
                       for run in ("cuda", "cpu", "tf32")}
    thr = float(snip_threshold(ref["sal"], SPARSITY))
    flips = {run: sum(int(((v > thr) != (ref["sal"][p] > thr)).sum())
                      for p, v in res[run]["sal"].items()) for run in ("cuda", "cpu", "tf32")}
    n = sum(m.numel() for m in snip.values())
    for stage, what in (("sal", "SNIP saliencies"),
                        ("after_snip", "parameters and running statistics after train_snip "
                                       "(2 steps, lr 0.1)"),
                        ("params", "the same after one run_magnitude iteration (2 steps, "
                                   "50% -> 60%; where the masks agree)")):
        d = dist[stage]
        print(f"train driver, {CNN_MODEL} full depth, B={CNN_CUT_BATCH}: {what}, relative L2 "
              f"from the CPU's f64 run: the card's f32 {d['cuda']:.3e}, the CPU's f32 "
              f"{d['cpu']:.3e} (the card's within 2x of it), the card with cuDNN TF32 "
              f"{d['tf32']:.3e} ({card})")
        assert d["cuda"] <= 2 * d["cpu"], (stage, d)
    print(f"SNIP masks at {SPARSITY} against the f64 run's threshold: the card's f32 "
          f"{flips['cuda']}, the CPU's f32 {flips['cpu']}, TF32 {flips['tf32']} of {n} differ; "
          f"magnitude masks differing from the f64 run's: "
          + ", ".join(f"{r} {sum(int((res[r]['masks'][k] != m).sum()) for k, m in ref['masks'].items())}"
                      for r in ("cuda", "cpu", "tf32"))
          + f"; seconds: card {res['cuda']['secs']:.1f}, CPU f32 {res['cpu']['secs']:.1f}, "
            f"CPU f64 {ref['secs']:.1f} ({card})")
    # bf16 loss and gradients at the card's SNIP-trained state
    state, xb = res["cuda"]["after_snip"], tuple(t.cpu() for t in batch)
    grads = {}
    for run, dev, dtype in (("card", res["cuda"]["device"], torch.bfloat16),
                            ("cpu", "cpu", torch.bfloat16), ("f64", "cpu", torch.float32)):
        model = build_model(CNN_MODEL).module()
        model.load_state_dict(state)
        model = model.to(device=dev, dtype=torch.float64 if run == "f64" else None)
        out = loss_and_grads(model, {k: m.to(dev) for k, m in snip.items()},
                             tuple(t.to(dev) for t in xb), 1000, compute_dtype=dtype)
        grads[run] = (float(out[0]), {k: g.cpu() for k, g in out[2].items()})
        del model
    loss_gap = abs(grads["card"][0] - grads["cpu"][0])
    g_card, g_cpu = (rel_l2(grads[r][1], grads["f64"][1]) for r in ("card", "cpu"))
    print(f"cpu-vs-card train {CNN_MODEL} bf16 B={CNN_CUT_BATCH}: loss {grads['card'][0]:.5f} vs "
          f"{grads['cpu'][0]:.5f} (gap {loss_gap:.2e}, tol 2e-2 relative); gradients relative "
          f"L2 from the f64 gradients: the card's {g_card:.3e}, the CPU's bf16 {g_cpu:.3e} "
          f"(the card's within 2x of it) ({card})")
    assert loss_gap <= 2e-2 * abs(grads["cpu"][0]), loss_gap
    assert g_card <= 2 * g_cpu, (g_card, g_cpu)


def cnn_phase(card, counters, keep_pth=None):
    """Phase 13: the CNN families through the entry points, ResNet-50 at
    full width and depth (1000 classes, the CLI's seed-42 weights), 224x224,
    ``--amp --batch-size 128 --workers 8`` on phase 12's ImageFolder (1024
    train, 256 val symlinks to the 8 fixture JPEGs): ``train`` SNIP to 50%
    for one epoch, then LRR (rate 0.2, threshold 36: two iterations of one
    epoch; threshold 35.9, as two rounds leave just under 36%); ``evaluate
    --amp`` over the LRR checkpoints; ``lost --arch resnet --model resnet50
    --resnet-dilate 2 --dtype bf16`` from the iteration-01
    checkpoint and ``lost --arch vgg16 --model vgg16_bottom --dtype bf16``
    from a seed-0 .pth with a 50% global magnitude mask, on N_JPEG_SHORT of
    phase 6's JPEGs. Checks: no attention or fused-MLP launch in any run,
    the first train and val batches equal to the CPU loader's, finite bf16
    losses, pruned slots zero in every LRR checkpoint and at their initial
    weights in the SNIP ones, performance.txt's sparsities those of the
    checkpoints, evaluate's acc1 equal to the driver's f32 eval, preds.pkl and
    the results txt against ``corloc``, the first LOST batch against
    ``make_batched_cnn_pipeline``; the driver card vs CPU against an f64
    run (``cnn_driver_card_vs_cpu``); LOST f32 at B=4 card vs CPU on two bucket
    shapes. Prints train e2e, step, decode-only and evaluate img/s, the
    CNN LOST pipeline's img/s at B=128, the CLI's e2e img/s and the peak
    device memory."""
    import dataclasses
    import json
    import shutil
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import (export_resnet, export_vgg16,
                                              save_torch_state_dict)
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.core.metrics import MetricsWriter
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.imagefolder import ImageFolder, ImageFolderLoader
    from vipers_torch.discovery import driver as ldrv
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.discovery.lost import lost_core
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train import driver as tdrv

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="vipers_torch_cnn_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, N_TRAIN_IMAGES, N_VAL_IMAGES, seed=4)
        b, m = BATCH, CNN_MODEL
        common = ["--model", m, "--num-classes", "1000", "--amp", "--batch-size", str(b),
                  "--workers", "8", "--data-path", data, "--epochs", "1", "--print-freq", "4"]
        cfg = TrainConfig(model=m, data_path=data, batch_size=b, workers=8, amp=True,
                          device="cpu")
        steps, evals = N_TRAIN_IMAGES // b, -(-N_VAL_IMAGES // b)

        def run_cli(argv):
            return run_cli_without_kernels(cli, argv, counters)

        ds = ImageFolder(os.path.join(data, "train"))
        loader = tdrv.train_loader(dataclasses.replace(cfg, workers=8), ds, 0)
        t0 = time.perf_counter()
        got = sum(len(lab) for _, lab in ImageFolderLoader(
            ds, loader.indices[:4 * b], b, loader.decode_fn, num_workers=8, drop_last=True,
            seed=loader.seed))
        dec = got / (time.perf_counter() - t0)

        # 1. SNIP, one epoch
        torch.cuda.reset_peak_memory_stats()
        snip_out = os.path.join(root, "snip")
        secs = run_cli(["train", *common, "--pruning-method", "snip", "--target-sparsity",
                        str(SPARSITY), "--output-dir", snip_out])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run = dict(tdrv.LAST_RUN)
        for kind, ld in (("train", tdrv.train_loader(cfg, ds, 0)),
                         ("val", tdrv.val_loader(cfg, ImageFolder(os.path.join(data, "val"))))):
            want_i, want_l = next(iter(ld))
            got_i, got_l = run[f"first_{kind}_batch"]
            assert got_i.dtype == np.uint8 and np.array_equal(got_i, want_i), kind
            assert np.array_equal(got_l, want_l), kind
        e2e = steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        with open(os.path.join(snip_out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss = [r["loss"] for r in recs if r["tag"] == "train"]
        assert len(loss) == 1 and np.isfinite(loss[0]), recs
        snip_sp = [r["sparsity"] for r in recs if r["tag"] == "prune"][0]
        init = export_resnet(build_model(m).init(torch.Generator().manual_seed(cfg.seed)))
        init = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in init.items()}
        for stem in ("epoch_0", "checkpoint"):
            check_checkpoint(os.path.join(snip_out, f"{m}_{stem}_snip_{SPARSITY}.pth"),
                             snip_sp, init=init, model=m)
        del init
        print(f"train CLI [snip] {m} bf16 B={b}: {steps} steps, {evals} eval batches, no "
              f"attention or fused-MLP launch; e2e {e2e:.1f} img/s ({steps * b} images, first "
              f"decode to the last checkpoint; {secs:.3f} s with the set-up); sparsity "
              f"{snip_sp:.4f}%, train loss {loss[0]:.4f}; peak device memory {peak:.2f} GiB; "
              f"first train and val batches equal to the CPU loader's; decode only (the PIL "
              f"train preset, 8 threads) {dec:.1f} img/s ({card})")
        remove_later(snip_out)

        # 2. LRR: two iterations of one epoch
        lrr_out = os.path.join(root, "lrr")
        # two rounds of 20% leave just under 36% of ResNet-50's weights
        # pruned (the counts round), so threshold 36 would take a third round
        secs = run_cli(["train", *common, "--pruning-method", "magnitude", "--pruning-rate",
                        "0.2", "--pruning-threshold", "35.9", "--output-dir", lrr_out])
        run = dict(tdrv.LAST_RUN)
        rows = MetricsWriter.read_performance_txt(os.path.join(lrr_out, "performance.txt"))
        assert len(rows) == 2, rows
        for it, (_, sp) in enumerate(rows):
            for stem in ("epoch_0", "checkpoint"):
                check_checkpoint(os.path.join(lrr_out, f"{m}_{stem}_pruning_iteration_"
                                                       f"{it:02d}.pth"), sp, model=m)
        e2e_lrr = 2 * steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        print(f"train CLI [magnitude] {m} 2 iterations: e2e {e2e_lrr:.1f} img/s "
              f"({2 * steps * b} images; {secs:.3f} s with the set-up); performance.txt {rows} "
              f"({card})")

        # 3. evaluate over the LRR checkpoints
        ev_out = os.path.join(root, "eval")
        secs = run_cli(["evaluate", *common, "--models-path", lrr_out, "--output-dir", ev_out])
        ev_rows = MetricsWriter.read_performance_txt(os.path.join(ev_out, "performance.txt"))
        f32 = f32_eval_acc1(cfg, [os.path.join(lrr_out, f"{m}_epoch_0_pruning_iteration_"
                                                        f"{it:02d}.pth") for it in range(2)], root)
        assert [a for a, _ in ev_rows] == f32, (ev_rows, f32)
        assert all(abs(e - t) <= 1e-4 for (_, e), (_, t) in zip(ev_rows, rows)), (ev_rows, rows)
        print(f"evaluate --amp {m} over 2 checkpoints: acc1 and sparsity {ev_rows} (acc1 equal "
              f"to the driver's f32 eval of the same checkpoints {f32}; the training run's bf16 "
              f"{[a for a, _ in rows]}); {2 * N_VAL_IMAGES / secs:.1f} img/s with the set-up "
              f"and 2 checkpoint loads ({card})")

        # 4. lost --arch resnet from the iteration-01 checkpoint, --arch vgg16
        voc = os.path.join(root, "VOC2007")
        items = voc_tree(voc, N_JPEG_SHORT, seed=3)
        vgg_pth = os.path.join(root, "vgg16_bottom.pth")
        vspec = build_model("vgg16_bottom")
        vparams = vspec.init(torch.Generator().manual_seed(0))
        vmasks = magnitude_prune(vparams, init_masks(vparams), amount=SPARSITY)
        save_torch_state_dict(export_vgg16(vparams, vmasks, bake_masks=False), vgg_pth)
        ckpt = os.path.join(lrr_out, f"{m}_epoch_0_pruning_iteration_01.pth")
        for tag, arch, model, pth, extra, dilate in (
                ("resnet", "resnet", m, ckpt, ["--resnet-dilate", str(CNN_DILATE)], CNN_DILATE),
                ("vgg16", "vgg16", "vgg16_bottom", vgg_pth, [], 1)):
            out = os.path.join(root, f"lost_{tag}")
            run_cli(["lost", "--arch", arch, "--model", model, *extra, "--dtype", "bf16",
                     "--dataset", "VOC07", "--set", "trainval", "--data-path", voc,
                     "--checkpoint", pth, "--batch-size", str(b), "--workers", "8",
                     "--output-dir", out])
            lrun = dict(ldrv.LAST_RUN)
            rescored, _ = check_cli_outputs(tag, out, voc, "trainval", items, lrun["failed"])
            check_first_cnn_batch(tag, pth, voc, items, out, lrun["failed"], model, dilate)
            print(f"lost --arch {arch} --model {model} bf16: {lrun['images']} images, "
                  f"{lrun['batches']} batches, {len(lrun['failed'])} seeds in the background, "
                  f"{rescored}; e2e {lrun['images'] / lrun['decode_to_preds_seconds']:.1f} "
                  f"img/s, no attention or fused-MLP launch ({card})")
        if keep_pth:  # phase 14's --exact-shapes run reads it
            shutil.copyfile(ckpt, keep_pth)
        remove_later(lrr_out)

        # step img/s: the CLI's session and batch, best of 3 windows of 6 steps
        s = tdrv.build_session(dataclasses.replace(cfg, device="cuda",
                                                   output_dir=os.path.join(root, "step")))
        images, labels = next(iter(tdrv._train_loader(s, 0)))
        x = s.normalize(images)
        reset_counts(*counters)
        s.train_step(s.state, (x, labels))
        torch.cuda.synchronize()
        assert all_launches(counters) == 0
        best = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(6):
                s.train_step(s.state, (x, labels))
            torch.cuda.synchronize()
            best = max(best, b * 6 / (time.perf_counter() - t1))
        print(f"train CLI session step {m} 224x224 bf16 {best:.1f} img/s at B={b} "
              f"({card})")
        del s, x
        torch.cuda.empty_cache()

        # the CNN LOST pipeline at B=128 and card vs CPU at B=4, f32
        spec = build_model(m, dilate=CNN_DILATE)
        params = spec.init(torch.Generator().manual_seed(0))
        masks = magnitude_prune(params, init_masks(params), amount=SPARSITY)
        ex16 = LostFeatureExtractor(spec, params, masks, compute_dtype=torch.bfloat16)
        rng = np.random.default_rng(9)
        (key, (imgs, hw)), = cnn_bucket_images(ex16, [(H, W)] * BATCH, rng).items()
        inp = ex16.prepare_cnn_batch(imgs, key, exact_hw=hw)
        one = ex16.prepare_cnn_batch(imgs[:1], key, exact_hw=hw[:1])
        reset_counts(*counters)
        ips, p50 = throughput(ex16.make_batched_cnn_pipeline(K_PATCHES), inp, one)
        assert all_launches(counters) == 0
        print(f"CNN LOST pipeline {m} dilate {CNN_DILATE} bf16 {key[0]}x{key[1]}: {ips:.1f} "
              f"img/s at B={BATCH}; p50 latency {p50:.2f} ms at B=1 ({card})")
        del ex16, inp
        ex32 = LostFeatureExtractor(spec, params, masks)
        # a landscape and a portrait bucket, exact sizes below the canonical input
        mixed = [(int(rng.integers(H - 63, H + 1)), int(rng.integers(W - 47, W + 1)))
                 for _ in range(N_CPU)] + [(int(rng.integers(W - 23, W + 1)),
                                            int(rng.integers(H - 63, H - 11))) for _ in range(N_CPU)]
        buckets = cnn_bucket_images(ex32, mixed, rng)
        assert len(buckets) == 2, list(buckets)
        compare_cnn_with_cpu(f"{m} f32 dilate {CNN_DILATE}", spec, params, masks, ex32, buckets,
                             lost_core)
        del ex32
        torch.cuda.empty_cache()

        # the f32 driver, card vs CPU, at full depth
        cut = os.path.join(root, "cut")
        imagefolder_tree(cut, 2 * CNN_CUT_BATCH, CNN_CUT_BATCH, seed=5)
        cnn_driver_card_vs_cpu(card, root, cut)
        print(f"phase 13 CNN families: no attention or fused-MLP launch; "
              f"{time.time() - t_phase:.1f} s")
    finally:
        remove_later(root)


# Phase 14: Swin-V2-T through the pruning and LOST entry points, and the
# per-image LOST path (Swin in both regimes, ResNet-50 --exact-shapes).
SWIN_MODEL = "swin_v2_t"
# torchvision's published swin_v2_t recipe
SWIN_CROPS = ["--train-crop-size", "256", "--val-resize-size", "260", "--val-crop-size", "256",
              "--interpolation", "bicubic"]
SWIN_CUT_BATCH, SWIN_BF16_BATCH = 4, 4  # the f32 driver and bf16 card-vs-CPU runs
N_SWIN_EXACT = 32  # JPEGs of the ResNet-50 --exact-shapes run
N_SWIN_LOST = 64  # JPEGs of each Swin per-image lost run (one image a forward)
N_LOST_CPU = 4  # fixture JPEGs of the per-image LOST card-vs-CPU check


def swin_cfg(**kw):
    """A TrainConfig at phase 14's crops (256, resize 260, bicubic)."""
    from vipers_torch.core.config import TrainConfig

    return TrainConfig(train_crop_size=256, val_resize_size=260, val_crop_size=256,
                       interpolation="bicubic", **kw)


def biased(spec, seed):
    """``spec``'s flax-default weights (seed) with every bias drawn from
    N(0, 0.02): a Swin's zero biases give window pad tokens exactly-zero k
    features (and LOST nothing to find)."""
    from vipers_torch.core.tree import flatten_dict, unflatten_dict

    g = torch.Generator().manual_seed(seed)
    params = spec.init(g)
    return unflatten_dict({p: (v + 0.02 * torch.randn(v.shape, generator=g)
                               if p[-1] == "bias" else v)
                           for p, v in flatten_dict(params).items()})


def decoded_fixture(n):
    """The first ``n`` fixture JPEGs host-normalized and tier-1 padded, as
    the per-image path decodes them: [(padded f32 (H, W, 3), (3, h, w))]."""
    from vipers_torch.data.detection import load_image_normalized

    fixture = os.path.join(REPO, "tests", "data", "torch_voc", "JPEGImages")
    out = []
    for f in sorted(os.listdir(fixture))[:n]:
        img = load_image_normalized(os.path.join(fixture, f))
        h, w = img.shape[:2]
        pad = np.zeros((-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, 3), np.float32)
        pad[:h, :w] = img
        out.append((pad, (3, h, w)))
    return out


def per_image_card_vs_cpu(tag, spec, params, masks, stats, card, **ex_kw):
    """``extract`` -> ``lost`` in f32 on N_LOST_CPU fixture JPEGs, the card
    against the CPU: features within 1e-3 of their scale, boxes equal (a
    seed may differ only inside a tie at the top score of the CPU's)."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.discovery.lost import lost

    exs = {d: LostFeatureExtractor(spec, params, masks, device=d, batch_stats=stats, **ex_kw)
           for d in ("cuda", "cpu")}
    worst, same = 0.0, 0
    for img, size in decoded_fixture(N_LOST_CPU):
        res = {}
        for d, ex in exs.items():
            feats, dims, valid, scales, _ = ex.extract(img, PATCH)
            try:
                out = lost(feats, dims, scales, size, k_patches=K_PATCHES, valid_dims=valid)
            except ValueError:
                out = None
            res[d] = (feats.float().cpu(), out)
        (gf, gout), (cf, cout) = res["cuda"], res["cpu"]
        scale = cf.abs().max().item()
        err = (gf - cf).abs().max().item()
        worst = max(worst, err / scale)
        assert err <= 1e-3 * scale, (tag, err, scale)
        assert (gout is None) == (cout is None), tag
        if gout is None:
            continue
        if gout[3] == cout[3]:
            assert np.array_equal(gout[0], cout[0]), (tag, gout[0], cout[0])
            same += 1
        else:
            sc = cout[2]
            assert sc[gout[3]] == sc[cout[3]] == sc.max(), (tag, gout[3], cout[3])
    print(f"per-image LOST f32 [{tag}] card vs CPU on {N_LOST_CPU} fixture JPEGs: features "
          f"within {worst:.2e} of their scale (tol 1e-3), {same} seeds and boxes equal, the "
          f"rest tied at the top score ({card})")
    del exs
    torch.cuda.empty_cache()


def check_first_image(tag, pth, voc, items, out, failed, model, extra, dtype=torch.bfloat16):
    """The first image of a per-image ``lost`` run: its box in preds.pkl
    equal to ``extract`` -> ``lost`` on the same host-normalized decode,
    the model loaded from ``pth`` as the CLI loads it (or both report the
    seed in the background). Returns the p50 ms of that call (20 calls
    after 3)."""
    import pickle

    from vipers_torch.core.checkpoint import infer_num_classes
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.detection import load_image_normalized
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import lost

    spec = build_model(model, **extra)
    params, stats, masks, _ = load_lost_checkpoint(pth, spec)
    if spec.num_classes and infer_num_classes(params) is not None:
        spec = build_model(model, num_classes=infer_num_classes(params), **extra)
    ex = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype, batch_stats=stats,
                              cnn_bucket=1, swin_all_windows=tag == "swin all windows")
    name = items[0][0]
    img = load_image_normalized(os.path.join(voc, "JPEGImages", f"{name}.jpg"))
    h, w = img.shape[:2]
    pad = np.zeros((-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, 3), np.float32)
    pad[:h, :w] = img

    def call():
        feats, dims, valid, scales, _ = ex.extract(pad, PATCH)
        try:
            return lost(feats, dims, scales, (3, h, w), k_patches=K_PATCHES,
                        valid_dims=valid)[0].tolist()
        except ValueError:
            return None

    want = call()
    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    if want is None:
        assert f"{name}.jpg" in failed, tag
    else:
        assert preds[f"{name}.jpg"] == want, (tag, preds[f"{name}.jpg"], want)
    lats = []
    for _ in range(23):
        t0 = time.perf_counter()
        call()
        lats.append(1e3 * (time.perf_counter() - t0))
    del ex
    return statistics.median(lats[3:])


def swin_driver_card_vs_cpu(card, root, data):
    """The f32 driver on swin_v2_t at full width and depth, built at
    stochastic depth 0 (registered for the call as ``swin_v2_t_sd0``; the
    two devices draw from different generators otherwise), B =
    SWIN_CUT_BATCH, 2 steps an epoch, the same seed-0 weights (biases drawn,
    ``biased``): on the card, on the CPU, and on the card with cuBLAS and
    cuDNN in TF32. SNIP's saliencies card vs CPU within 1e-5 of their
    scale (the TF32 run's printed beside); every run then trains the card's
    SNIP masks (``train_snip``, 2 steps) and one ``run_magnitude``
    iteration (2 steps, prune 20% more, bake): parameters within 1e-4 of
    the CPU's where the masks agree, after each stage (TF32 printed). Then
    one bf16 forward and backward at B = SWIN_BF16_BATCH from the card's
    SNIP-trained state: loss within 2e-2 (relative) and gradients within
    3e-2 (relative L2) of the CPU's bf16."""
    import dataclasses

    from vipers_torch.core import registry
    from vipers_torch.models.swin import SwinV2Config, swin_spec
    from vipers_torch.pruning.snip import snip_threshold
    from vipers_torch.train import driver as tdrv
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import loss_and_grads

    name = "swin_v2_t_sd0"
    registry._ensure_builtins_imported()
    registry._BUILTIN_MODELS[name] = lambda num_classes=1000, input_size=(256, 256): swin_spec(
        name, SwinV2Config(num_classes=num_classes, stochastic_depth_prob=0.0), input_size)
    try:
        spec = registry.build_model(name)
        params = biased(spec, 0)
        res, snip = {}, None
        for run in ("card", "cpu", "tf32"):
            dev = "cpu" if run == "cpu" else "cuda"
            t0 = time.time()
            cfg = swin_cfg(model=name, data_path=data, num_classes=1000,
                           batch_size=SWIN_CUT_BATCH, workers=8, pruning_method="snip",
                           target_sparsity=SPARSITY, pruning_rate=0.2, pruning_threshold=55.0,
                           optim=OptimConfig(lr=0.01, epochs=1), seed=0, print_freq=0,
                           output_dir=os.path.join(root, f"swin_cut_{run}"), device=dev)
            tf32 = run == "tf32"
            with cublas_tf32(tf32), cudnn_tf32() if tf32 else contextlib.nullcontext():
                s = tdrv.build_session(cfg, params=params)
                sal = {p: v.cpu() for p, v in tdrv.snip_saliencies(s).items()}
                if snip is None:
                    snip = {k: m.cpu() for k, m in tdrv.snip_masks(s, sal).items()}
                    batch = tuple(t.cpu() for t in next(iter(tdrv._train_loader(s, 0))))
                    batch = (s.normalize(batch[0].to(s.device)).cpu(), batch[1])
                s.state.masks = {k: m.to(s.device) for k, m in snip.items()}
                tdrv.train_snip(s)
                after = {k: v.detach().cpu().clone() for k, v in s.state.params.items()}
                _, rows = tdrv.run_magnitude(s)
            res[run] = dict(sal=sal, after_snip=after, rows=rows, secs=time.time() - t0,
                            params={k: v.detach().cpu() for k, v in s.state.params.items()},
                            masks={k: m.cpu() for k, m in s.state.masks.items()})
            del s
            torch.cuda.empty_cache()
        cpu = res["cpu"]
        scale = max(float(v.max()) for v in cpu["sal"].values())
        err = {r: max(float((res[r]["sal"][p] - v).abs().max()) for p, v in cpu["sal"].items())
               for r in ("card", "tf32")}
        thr = float(snip_threshold(cpu["sal"], SPARSITY))
        flips = {r: sum(int(((res[r]["sal"][p] > thr) != (v > thr)).sum())
                        for p, v in cpu["sal"].items()) for r in ("card", "tf32")}
        print(f"train driver f32 SNIP, {SWIN_MODEL} full depth at stochastic depth 0, "
              f"B={SWIN_CUT_BATCH}, 256x256, card vs CPU: saliencies max_abs_err "
              f"{err['card']:.3e}, {err['card'] / scale:.2e} of their scale {scale:.3e} (tol "
              f"1e-5), {flips['card']} masks off the CPU's threshold; cuBLAS and cuDNN in TF32: "
              f"{err['tf32']:.3e}, {err['tf32'] / scale:.2e}, {flips['tf32']} masks ({card})")
        assert err["card"] <= 1e-5 * scale, (err, scale)
        for stage, what in (("after_snip", "after train_snip (2 steps, lr 0.01, the card's SNIP "
                                            "masks)"),
                            ("params", "after one run_magnitude iteration (2 steps, 50% -> 60%; "
                                       "where the masks agree)")):
            errs = {}
            for r in ("card", "tf32"):
                e = 0.0
                for k, p in cpu[stage].items():
                    keep = (cpu["masks"][k] == res[r]["masks"][k]) if (
                        stage == "params" and k in cpu["masks"]) else torch.ones_like(
                        p, dtype=torch.bool)
                    e = max(e, float((res[r][stage][k] - p).abs()[keep].max()))
                errs[r] = e
            print(f"train driver f32 {SWIN_MODEL} card vs CPU, parameters {what}: max_abs_err "
                  f"{errs['card']:.3e} (tol 1e-4); TF32 {errs['tf32']:.3e} ({card})")
            assert errs["card"] <= 1e-4, (stage, errs)
        assert cpu["rows"][0][1] == res["card"]["rows"][0][1], (cpu["rows"], res["card"]["rows"])
        n = sum(m.numel() for m in cpu["masks"].values())
        mflips = sum(int((res["card"]["masks"][k] != m).sum()) for k, m in cpu["masks"].items())
        print(f"magnitude masks card vs CPU: {mflips} of {n} differ; seconds: card "
              f"{res['card']['secs']:.1f}, CPU {cpu['secs']:.1f}, TF32 {res['tf32']['secs']:.1f} "
              f"({card})")
        # bf16 loss and gradients at the card's SNIP-trained state
        state = res["card"]["after_snip"]
        xb = (batch[0][:SWIN_BF16_BATCH], batch[1][:SWIN_BF16_BATCH])
        grads = {}
        for run, dev in (("card", "cuda"), ("cpu", "cpu")):
            model = spec.module()
            model.load_state_dict(state)
            model = model.to(dev)
            out = loss_and_grads(model, {k: m.to(dev) for k, m in snip.items()},
                                 tuple(t.to(dev) for t in xb), 1000,
                                 compute_dtype=torch.bfloat16)
            grads[run] = (float(out[0]), {k: g.cpu() for k, g in out[2].items()})
            del model
        gap = abs(grads["card"][0] - grads["cpu"][0])
        g_err = rel_l2(grads["card"][1], grads["cpu"][1])
        print(f"cpu-vs-card train {SWIN_MODEL} bf16 B={SWIN_BF16_BATCH}: loss "
              f"{grads['card'][0]:.5f} vs {grads['cpu'][0]:.5f} (gap {gap:.2e}, tol 2e-2 "
              f"relative); gradients relative L2 {g_err:.3e} (tol 3e-2) ({card})")
        assert gap <= 2e-2 * abs(grads["cpu"][0]), gap
        assert g_err <= 3e-2, g_err
    finally:
        del registry._BUILTIN_MODELS[name]


def swin_phase(card, counters, resnet_pth=None):
    """Phase 14: Swin-V2-T through the entry points, swin_v2_t at full
    width and depth (1000 classes, the CLI's seed-42 weights, stochastic
    depth 0.2), torchvision's published recipe (256 crops, val resize 260,
    bicubic), ``--amp --batch-size 128 --workers 8`` on phase 12's
    ImageFolder (256 train, 256 val symlinks to the 8 fixture JPEGs):
    ``train`` SNIP to 50% for one epoch, then LRR (rate 0.2, threshold 35.9:
    two iterations of one epoch; two rounds leave 35.99999945%, so 36 would
    take a third); ``evaluate --amp`` over the LRR checkpoints; ``lost
    --arch swin --model swin_v2_t --dtype bf16`` from the iteration-01
    checkpoint on 64 of phase 6's JPEGs, in the first-window regime and
    with ``--swin-all-windows``; ``lost --arch resnet --model resnet50
    --resnet-dilate 2 --exact-shapes --dtype bf16`` on N_SWIN_EXACT of them
    from phase 13's iteration-01 .pth (``resnet_pth``; a seed-0 .pth with a
    50% mask when the phase runs alone). Checks: no attention or fused-MLP
    launch in any run (counters set to 0 before each, read after), the
    first train and val batches equal to the CPU loader's, finite bf16
    losses, pruned slots zero in every LRR checkpoint and at their initial
    weights in the SNIP ones, no qkv or CPB kernel masked, performance.txt's
    sparsities those of the checkpoints, ``evaluate``'s acc1 equal to the
    driver's f32 eval of the same checkpoints, preds.pkl and the results txt
    against ``corloc``, the first image's box against ``extract`` ->
    ``lost``. Card vs CPU: the f32 forward at B=2, 256x256 (logits and
    features within 1e-4 of their scale); the f32 driver and bf16 step
    (``swin_driver_card_vs_cpu``); stochastic depth's draws on the card
    (every block's keep frequency over 4096 samples within 5 sigma of 1 -
    rate, kept samples scaled by exactly 1 / keep); per-image LOST f32 in
    both regimes and ResNet-50 --exact-shapes (``per_image_card_vs_cpu``).
    Prints train e2e, step (best of 3 windows of 6), decode-only and
    evaluate img/s, the per-image LOST e2e img/s and p50 of both regimes
    and of --exact-shapes, and the peak device memory."""
    import dataclasses
    import json
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import (export_resnet, export_swin_v2_t, family,
                                              save_torch_state_dict)
    from vipers_torch.core.metrics import MetricsWriter
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.imagefolder import ImageFolder, ImageFolderLoader
    from vipers_torch.discovery import driver as ldrv
    from vipers_torch.discovery.driver import load_lost_checkpoint
    from vipers_torch.models.cnn import exact_f32_convs
    from vipers_torch.models.stochastic import drop_path, dropout_generator
    from vipers_torch.models.swin import SwinBlockV2
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train import driver as tdrv

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="vipers_torch_swin_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, N_TRAIN_IMAGES, N_VAL_IMAGES, seed=4)
        b, m = BATCH, SWIN_MODEL
        common = ["--model", m, "--num-classes", "1000", "--amp", "--batch-size", str(b),
                  "--workers", "8", "--data-path", data, "--epochs", "1", "--print-freq", "4",
                  *SWIN_CROPS]
        cfg = swin_cfg(model=m, data_path=data, batch_size=b, workers=8, amp=True, device="cpu")
        steps, evals = N_TRAIN_IMAGES // b, -(-N_VAL_IMAGES // b)

        def run_cli(argv):
            return run_cli_without_kernels(cli, argv, counters)

        ds = ImageFolder(os.path.join(data, "train"))
        loader = tdrv.train_loader(dataclasses.replace(cfg, workers=8), ds, 0)
        t0 = time.perf_counter()
        got = sum(len(lab) for _, lab in ImageFolderLoader(
            ds, loader.indices[:4 * b], b, loader.decode_fn, num_workers=8, drop_last=True,
            seed=loader.seed))
        dec = got / (time.perf_counter() - t0)

        # 1. SNIP, one epoch
        torch.cuda.reset_peak_memory_stats()
        snip_out = os.path.join(root, "snip")
        secs = run_cli(["train", *common, "--pruning-method", "snip", "--target-sparsity",
                        str(SPARSITY), "--output-dir", snip_out])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run = dict(tdrv.LAST_RUN)
        for kind, ld in (("train", tdrv.train_loader(cfg, ds, 0)),
                         ("val", tdrv.val_loader(cfg, ImageFolder(os.path.join(data, "val"))))):
            want_i, want_l = next(iter(ld))
            got_i, got_l = run[f"first_{kind}_batch"]
            assert got_i.dtype == np.uint8 and np.array_equal(got_i, want_i), kind
            assert np.array_equal(got_l, want_l), kind
        e2e = steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        with open(os.path.join(snip_out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss = [r["loss"] for r in recs if r["tag"] == "train"]
        assert len(loss) == 1 and np.isfinite(loss[0]), recs
        snip_sp = [r["sparsity"] for r in recs if r["tag"] == "prune"][0]
        init = export_swin_v2_t(build_model(m).init(torch.Generator().manual_seed(cfg.seed)))
        init = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in init.items()}
        for stem in ("epoch_0", "checkpoint"):
            path = os.path.join(snip_out, f"{m}_{stem}_snip_{SPARSITY}.pth")
            check_checkpoint(path, snip_sp, init=init, model=m)
            masked = [k for k in torch.load(path, map_location="cpu", weights_only=False)["model"]
                      if k.endswith("_mask")]
            assert masked and not any("qkv" in k or "cpb" in k for k in masked), masked
        del init
        print(f"train CLI [snip] {m} bf16 B={b} 256x256: {steps} steps, {evals} eval batches, "
              f"no attention or fused-MLP launch; e2e {e2e:.1f} img/s ({steps * b} images, first "
              f"decode to the last checkpoint; {secs:.3f} s with the set-up); sparsity "
              f"{snip_sp:.4f}% (no qkv or CPB kernel masked), train loss {loss[0]:.4f}; peak "
              f"device memory {peak:.2f} GiB; first train and val batches equal to the CPU "
              f"loader's; decode only (the PIL bicubic train preset, 8 threads) {dec:.1f} img/s "
              f"({card})")
        remove_later(snip_out)

        # 2. LRR: two iterations of one epoch
        lrr_out = os.path.join(root, "lrr")
        secs = run_cli(["train", *common, "--pruning-method", "magnitude", "--pruning-rate",
                        "0.2", "--pruning-threshold", "35.9", "--output-dir", lrr_out])
        run = dict(tdrv.LAST_RUN)
        rows = MetricsWriter.read_performance_txt(os.path.join(lrr_out, "performance.txt"))
        assert len(rows) == 2, rows
        ckpts = [os.path.join(lrr_out, f"{m}_epoch_0_pruning_iteration_{it:02d}.pth")
                 for it in range(2)]
        for it, (_, sp) in enumerate(rows):
            for stem in ("epoch_0", "checkpoint"):
                check_checkpoint(os.path.join(lrr_out, f"{m}_{stem}_pruning_iteration_"
                                                       f"{it:02d}.pth"), sp, model=m)
        e2e_lrr = 2 * steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
        print(f"train CLI [magnitude] {m} 2 iterations: e2e {e2e_lrr:.1f} img/s "
              f"({2 * steps * b} images; {secs:.3f} s with the set-up); performance.txt {rows} "
              f"({card})")

        # 3. evaluate over the LRR checkpoints, in f32
        ev_out = os.path.join(root, "eval")
        secs = run_cli(["evaluate", *common, "--models-path", lrr_out, "--output-dir", ev_out])
        ev_rows = MetricsWriter.read_performance_txt(os.path.join(ev_out, "performance.txt"))
        f32 = f32_eval_acc1(cfg, ckpts, root)
        assert [a for a, _ in ev_rows] == f32, (ev_rows, f32)
        assert all(abs(e - t) <= 1e-4 for (_, e), (_, t) in zip(ev_rows, rows)), (ev_rows, rows)
        print(f"evaluate --amp {m} over 2 checkpoints: acc1 and sparsity {ev_rows} (acc1 equal "
              f"to the driver's f32 eval {f32}); {2 * N_VAL_IMAGES / secs:.1f} img/s with the "
              f"set-up and 2 checkpoint loads ({card})")

        # 4. lost --arch swin from the iteration-01 checkpoint, both regimes;
        # lost --arch resnet --exact-shapes
        voc = os.path.join(root, "VOC2007")
        items = voc_tree(voc, N_SWIN_LOST, seed=3)
        voc_exact = os.path.join(root, "VOC2007_exact")
        items_exact = voc_tree(voc_exact, N_SWIN_EXACT, seed=3)
        if resnet_pth is None:
            resnet_pth = os.path.join(root, "resnet50.pth")
            rspec = build_model(CNN_MODEL, dilate=CNN_DILATE)
            rparams = rspec.init(torch.Generator().manual_seed(0))
            save_torch_state_dict(export_resnet(rparams, masks=magnitude_prune(
                rparams, init_masks(rparams), amount=SPARSITY), bake_masks=False), resnet_pth)
        lost_rates = {}
        for tag, arch, model, pth, extra, data_dir, its in (
                ("swin first window", "swin", m, ckpts[1], [], voc, items),
                ("swin all windows", "swin", m, ckpts[1], ["--swin-all-windows"], voc, items),
                ("resnet --exact-shapes", "resnet", CNN_MODEL, resnet_pth,
                 ["--resnet-dilate", str(CNN_DILATE), "--exact-shapes"], voc_exact,
                 items_exact)):
            out = os.path.join(root, f"lost_{arch}_{len(lost_rates)}")
            run_cli(["lost", "--arch", arch, "--model", model, *extra, "--dtype", "bf16",
                     "--dataset", "VOC07", "--set", "trainval", "--data-path", data_dir,
                     "--checkpoint", pth, "--workers", "8", "--output-dir", out])
            lrun = dict(ldrv.LAST_RUN)
            assert lrun["per_image"] and lrun["images"] == len(its), lrun
            rescored, _ = check_cli_outputs(tag, out, data_dir, "trainval", its, lrun["failed"])
            p50 = check_first_image(tag, pth, data_dir, its, out, lrun["failed"], model,
                                    {"dilate": CNN_DILATE} if arch == "resnet" else {})
            ips = lrun["images"] / lrun["decode_to_preds_seconds"]
            lost_rates[tag] = (ips, p50)
            print(f"lost --arch {arch} --model {model} {' '.join(extra)} bf16, one image at a "
                  f"time: {lrun['images']} images, {len(lrun['failed'])} seeds in the "
                  f"background, {rescored}; e2e {ips:.1f} img/s; p50 {p50:.2f} ms an image "
                  f"(extract -> lost, the first image); first image's box equal to extract -> "
                  f"lost's; no attention or fused-MLP launch ({card})")

        # the per-image LOST path f32, card vs CPU
        spec = build_model(m)
        params, _, masks, _ = load_lost_checkpoint(ckpts[1], spec)
        for tag, all_windows in (("swin first window", False), ("swin all windows", True)):
            per_image_card_vs_cpu(tag, spec, params, masks, None, card,
                                  swin_all_windows=all_windows)
        rspec = build_model(CNN_MODEL, dilate=CNN_DILATE)
        rparams, rstats, rmasks, _ = load_lost_checkpoint(resnet_pth, rspec)
        per_image_card_vs_cpu("resnet50 --exact-shapes", rspec, rparams, rmasks, rstats, card,
                              cnn_bucket=1)
        remove_later(lrr_out)

        # step img/s: the CLI's session and batch, best of 3 windows of 6 steps
        s = tdrv.build_session(dataclasses.replace(cfg, device="cuda",
                                                   output_dir=os.path.join(root, "step")))
        images, labels = next(iter(tdrv._train_loader(s, 0)))
        x = s.normalize(images)
        reset_counts(*counters)
        s.train_step(s.state, (x, labels))
        torch.cuda.synchronize()
        assert all_launches(counters) == 0
        best = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(6):
                s.train_step(s.state, (x, labels))
            torch.cuda.synchronize()
            best = max(best, b * 6 / (time.perf_counter() - t1))
        print(f"train CLI session step {m} 256x256 bf16 {best:.1f} img/s at B={b} ({card})")
        # stochastic depth's draws on the card: each block's rate, the
        # step's generator, 4096 samples
        worst = 0.0
        for i, blk in enumerate(b_ for b_ in s.state.model.blocks if isinstance(b_, SwinBlockV2)):
            rate = blk.sd_rate
            if rate == 0.0:
                continue
            keep = 1.0 - rate
            y = torch.randn(4096, 1, 1, 8, device="cuda")
            out = drop_path(y, rate, True, dropout_generator(cfg.seed, i, "cuda"))
            kept = (out != 0).flatten(1).any(dim=1)
            sigma = (keep * rate / 4096) ** 0.5
            dev_ = abs(kept.float().mean().item() - keep) / sigma
            worst = max(worst, dev_)
            assert dev_ <= 5, (i, rate, dev_)
            assert torch.equal(out[kept], y[kept] / keep) and not out[~kept].any(), i
        rates = [round(b_.sd_rate, 4) for b_ in s.state.model.blocks if isinstance(b_, SwinBlockV2)]
        print(f"stochastic depth on the card, rates {rates}: keep frequencies over 4096 samples "
              f"within {worst:.2f} sigma of 1 - rate (tol 5), kept samples scaled by exactly "
              f"1 / keep ({card})")
        del s, x
        torch.cuda.empty_cache()

        # the f32 forward at B=2, 256x256, card vs CPU
        spec = build_model(m)
        model = spec.module().eval()
        model.load_state_dict(family(spec).state_dict(biased(spec, 1)))
        xin = torch.randn(2, 256, 256, 3, generator=torch.Generator().manual_seed(2))
        with torch.no_grad(), exact_f32_convs():
            ref = model(xin)
            got = model.cuda()(xin.cuda())
        for what, g, r in (("logits", got[0], ref[0]),
                           ("features", got[1]["features"], ref[1]["features"])):
            scale = r.abs().max().item()
            err = (g.cpu() - r).abs().max().item()
            print(f"cpu-vs-card {m} f32 forward B=2 256x256 {what}: max_abs_err {err:.3e}, "
                  f"{err / scale:.2e} of their scale {scale:.3g} (tol 1e-4) ({card})")
            assert err <= 1e-4 * scale, (what, err, scale)
        del model, got
        torch.cuda.empty_cache()

        # the f32 driver and the bf16 step, card vs CPU
        cut = os.path.join(root, "cut")
        imagefolder_tree(cut, 2 * SWIN_CUT_BATCH, SWIN_CUT_BATCH, seed=5)
        swin_driver_card_vs_cpu(card, root, cut)
        print(f"phase 14 Swin-V2-T: no attention or fused-MLP launch; per-image LOST "
              f"{ {k: (round(v[0], 1), round(v[1], 2)) for k, v in lost_rates.items()} } "
              f"(img/s, p50 ms); {time.time() - t_phase:.1f} s")
    finally:
        remove_later(root)


EXPLAIN_HEADS, EXPLAIN_T = 12, 769  # ViT-B/16 on the fixture's 500x375 image, padded
EXPLAIN_EVAL_IMAGES = 2  # of the 8 fixture JPEGs


def check_flash_explain(fa, gen, heads=EXPLAIN_HEADS, tag="explain"):
    """Rows 1 and 12-13 f32 against their plain versions at explain-eval's
    shape: B*H = 1*``heads`` (ViT-B/16's 12; ``dino_vit_small``'s 6), T =
    769, hd 64, no key mask (the forward: atol 1e-5 rtol 1e-4, lse 1e-4;
    the backward: dq, dk, dv within 1e-4 of each one's scale). Library
    calls: SDPA and its backward without a mask. Returns the two rows,
    named with ``tag``."""
    b, h, t, hd = 1, heads, EXPLAIN_T, 64
    q, k, v, cot = (torch.randn(b, h, t, hd, generator=gen, device="cuda") for _ in range(4))
    scale = hd ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, scale)
    want, want_lse = fa.flash_attention_plain(q, k, v, None, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    err = (out - want).abs().max().item()
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, None, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, None, scale))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * 4 + lse.numel() * 4
    bms, by, shares = forward_bound(flops, nbytes, torch.float32, ms)
    shape = f"B*H = {b}*{h}, T = {t}, hd {hd}, no key mask"
    print(f"flash_attention_fwd[f32, {tag}] max_abs_err {err:.3e} (atol 1e-5 rtol 1e-4) "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {shares}) plain {plain_ms:.3f} "
          f"ms sdpa {lib_ms:.3f} ms bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) at {shape}")
    rows = [{"name": f"flash_attention_fwd[f32, {tag}]", "route": "cuda",
             "source": "vipers_torch/csrc/flash_attention_fwd.cu",
             "replaces": "vipers/ops/flash_attention.py:91", "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}]
    args = (q, k, v, None, out, lse, cot, scale)
    got = fa.flash_attention_bwd(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [scaled_err(a, c, 1e-4) for a, c in zip(got, want)]
    ms = cuda_ms(lambda: fa.flash_attention_bwd(*args))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args))
    lib_ms = sdpa_bwd_ms(q, k, v, cot, None)
    flops = 10 * b * h * t * t * hd
    nbytes = 8 * q.numel() * 4 + lse.numel() * 4
    bms, by = bound(3 * flops, nbytes, PEAK_TF32)
    fma_ms = bound(flops, nbytes, PEAK_F32)[0]
    print(f"flash_attention_bwd[f32, {tag}] max_abs_err {max(e for e, _ in errs):.3e} (1e-4 "
          f"of each of dq, dk, dv's scale; worst {max(e / sc for e, sc in errs):.2e} of it) "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.1%} of its 3xTF32 "
          f"bound, {fma_ms / ms:.1%} of its FMA bound {fma_ms:.4f} ms) plain {plain_ms:.3f} ms "
          f"sdpa-backward {lib_ms:.3f} ms bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) at {shape}")
    rows.append({"name": f"flash_attention_bwd[f32, {tag}]", "route": "cuda",
                 "source": "vipers_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                             "(_flash_attention_bwd_dkv) and :1287 (_flash_attention_bwd_dq)",
                 "max_abs_err": max(e for e, _ in errs), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return rows


def explain_voc(root):
    """A VOC root of the 8 fixture JPEGs (symlinks) with SegmentationClass
    PNGs drawn from their XML boxes (255 inside every object's box, 0
    elsewhere). Returns {stem: (w, h)}."""
    import xml.etree.ElementTree as ET

    from PIL import Image

    fixture = os.path.join(REPO, "tests", "data", "torch_voc")
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "SegmentationClass"))
    sizes = {}
    for f in sorted(os.listdir(os.path.join(fixture, "JPEGImages"))):
        stem = f[:-4]
        os.symlink(os.path.join(fixture, "JPEGImages", f), os.path.join(root, "JPEGImages", f))
        ann = ET.parse(os.path.join(fixture, "Annotations", f"{stem}.xml")).getroot()
        w, h = int(ann.find("size/width").text), int(ann.find("size/height").text)
        mask = np.zeros((h, w), np.uint8)
        for obj in ann.findall("object"):
            bb = [int(float(obj.find(f"bndbox/{c}").text)) for c in
                  ("xmin", "ymin", "xmax", "ymax")]
            mask[bb[1] - 1: bb[3], bb[0] - 1: bb[2]] = 255
        Image.fromarray(mask).save(os.path.join(root, "SegmentationClass", f"{stem}.png"))
        sizes[stem] = (w, h)
    return sizes


def explain_card_vs_cpu(spec, card_model, cpu_model, voc, stem, label="ViT-B/16"):
    """The card's f32 ``compute_heatmaps`` against the CPU's on one VOC
    image (IG at 4 steps, the same CPU-drawn noise): map errors over their
    scales, RMA/RRA; LRP beside an f64 CPU run of the rule; IG's profile.
    A transformer's image is padded to its patch multiple and its attention
    map held too; a CNN runs at the image's size."""
    from PIL import Image

    from vipers_torch.data.detection import load_image_normalized
    from vipers_torch.explain import driver as xd
    from vipers_torch.explain.lrp import lrp_attribution
    from vipers_torch.explain.metrics import evaluate_single
    from vipers_torch.models.cnn import exact_f32_convs

    img = load_image_normalized(os.path.join(voc, "JPEGImages", f"{stem}.jpg"))
    gt = np.asarray(Image.open(os.path.join(voc, "SegmentationClass", f"{stem}.png")).convert("L"),
                    dtype=np.float64)
    vit = spec.family in ("vit", "dino_vit")
    p = spec.patch_size if vit else 1
    ph, pw = -(-img.shape[0] // p) * p, -(-img.shape[1] // p) * p
    padded = np.zeros((ph, pw, 3), np.float32)
    padded[: img.shape[0], : img.shape[1]] = img
    maps = ["gradcam", "ig"] + (["attention"] if vit else [])
    methods = [*maps, "lrp"]
    t0 = time.perf_counter()
    card = xd.compute_heatmaps(spec, card_model, padded, methods, ig_steps=4)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = xd.compute_heatmaps(spec, cpu_model, padded, methods, ig_steps=4)
    t_cpu = time.perf_counter() - t0
    assert int(np.argmax(card["prediction"])) == int(np.argmax(cpu["prediction"]))
    parts = []
    for m in maps:
        sc = float(np.abs(cpu[m]).max())
        rel = float(np.abs(card[m] - cpu[m]).max()) / sc
        pooling = None if cpu[m].ndim == 2 else "sum,abs"
        sc_card, _ = evaluate_single(card[m], gt, pooling)
        sc_cpu, _ = evaluate_single(cpu[m], gt, pooling)
        d_mass = abs(float(sc_card["mass"]) - float(sc_cpu["mass"]))
        d_rank = abs(float(sc_card["rank"]) - float(sc_cpu["rank"]))
        assert d_mass <= 1e-4 and d_rank <= 1e-3, (m, d_mass, d_rank)
        if m == "ig" and not vit:
            # a CNN's IG backward crosses relu6 kinks at exact zeros (masked
            # weights, clamped activations), where f32 rounding of either
            # side flips a gradient: the CPU's own f32 map lies ~4e-3 of its
            # scale from an f64 run. So the card's is held as LRP is, by its
            # cosine to the CPU's, with both maps' distances from f64 printed
            a, b = card[m].ravel().astype(np.float64), cpu[m].ravel().astype(np.float64)
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            ref = ig_f64(spec, cpu_model, padded, int(np.argmax(cpu["prediction"])))
            d64 = {k: float(np.abs(v - ref).max() / np.abs(ref).max())
                   for k, v in (("card", card[m]), ("cpu", cpu[m]))}
            assert cos >= 0.999, (m, cos, rel)
            what = (f"cosine {cos:.6f}, {rel:.2e} of its scale from the CPU's; from an f64 "
                    f"CPU run card {d64['card']:.2e}, cpu {d64['cpu']:.2e}")
        else:
            assert rel <= 1e-4, (m, rel)
            what = f"{rel:.2e} of its scale"
        parts.append(f"{m} {what} (RMA {float(sc_cpu['mass']):.4f}, |d| {d_mass:.1e}; RRA "
                     f"{float(sc_cpu['rank']):.4f}, |d| {d_rank:.1e})")
    size = f"{pw}x{ph}" + (f", T = {(ph // p) * (pw // p) + 1}" if vit else "")
    print(f"explain card vs CPU [{label}] ({stem}, {size}, IG 2 x 4 steps): {'; '.join(parts)}; "
          f"card {t_card:.1f} s, CPU {t_cpu:.1f} s")
    # LRP: the relevance reaching the input passes a division by y + eps
    # sign(y) at every Dense/Conv; over ViT-B/16's 12 blocks f32 rounding
    # moves it by up to percents of its scale, at eps 1e-2 as at its eps
    # 1e-6, on the card and on the CPU alike. So the card's map, its map on
    # the einsum route (no flash kernel) and the CPU's are printed with
    # their distances from an f64 CPU run of the rule (einsum attention:
    # the flash kernels take f32/bf16); the card's must be finite, for the
    # same target, and point the CPU's way (cosine >= 0.999 at eps 1e-2).
    # The small-ViT CUDA test holds LRP to 1e-3 of its scale.
    import copy

    x = torch.from_numpy(padded)[None]
    m64 = copy.deepcopy(cpu_model).double()
    target = int(np.argmax(cpu["prediction"]))
    prev = os.environ.get("VIPERS_FLASH_MIN_T")
    parts = []
    # MobileNetV2's relevance at eps 1e-6 overflows f32 in both packages
    # (53 layers of division by y + eps sign(y)): it is held at 1e-2 only
    for eps in (1e-2, 1e-6) if vit else (1e-2,):
        rel = {}
        for tag, model, xx in (("card", card_model, x.cuda()), ("cpu", cpu_model, x),
                               ("f64", m64, x.double()), ("card einsum", card_model, x.cuda())):
            if tag in ("f64", "card einsum"):
                os.environ["VIPERS_FLASH_MIN_T"] = "1000000"
            try:
                with exact_f32_convs():  # compute_heatmaps' scope: cuDNN's TF32 off
                    rel[tag], t = lrp_attribution(xd._apply_fn(spec, model, ph, pw), model,
                                                  xx, eps=eps)
            finally:
                if prev is None:
                    os.environ.pop("VIPERS_FLASH_MIN_T", None)
                else:
                    os.environ["VIPERS_FLASH_MIN_T"] = prev
            assert t == target and np.isfinite(rel[tag]).all(), (tag, t, target)
        sc = float(np.abs(rel["f64"]).max())
        d = {k: float(np.abs(rel[k] - rel["f64"]).max()) / sc
             for k in ("card", "card einsum", "cpu")}
        a, b = rel["card"].ravel().astype(np.float64), rel["cpu"].ravel().astype(np.float64)
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        if eps == 1e-2:
            assert cos >= 0.999, cos
        parts.append(f"eps {eps:g}: card/CPU cosine {cos:.6f}; from an f64 CPU run "
                     + ", ".join(f"{k} {v:.2e}" for k, v in d.items()) + " of its scale")
    print(f"explain card vs CPU [{label}] lrp (ill conditioned in f32): {'; '.join(parts)}")
    ig_profile(spec, card_model, padded, label)


def ig_f64(spec, cpu_model, img, target, steps=4):
    """``compute_heatmaps``' IG (SmoothGrad 2 x ``steps``, the same seed-0
    CPU noise) run in f64 on a copy of the CPU model: CHW."""
    import copy

    from vipers_torch.explain import driver as xd
    from vipers_torch.explain.attribution import make_integrated_gradients, make_smoothgrad

    m64 = copy.deepcopy(cpu_model).double()
    apply = xd._apply_fn(spec, m64, *img.shape[:2])

    def score(xx, t):
        return apply(xx)[0][torch.arange(xx.shape[0]), t]

    sg = make_smoothgrad(make_integrated_gradients(score, n_steps=steps), nt_samples=2)
    x = torch.from_numpy(img.astype(np.float64))[None]
    return np.transpose(sg(None, x, torch.tensor([target]))[0].numpy(), (2, 0, 1))


def ig_profile(spec, model, padded, label="ViT-B/16"):
    """Where IG's time goes on the card: 8 gradients (2 x 4 steps) under
    ``torch.profiler``: wall, device busy share, kernels a gradient, the
    GEMMs' and the flash kernels' shares of the device time."""
    from torch.profiler import ProfilerActivity, profile

    from vipers_torch.explain import driver as xd
    from vipers_torch.tools.profile_lost import _intervals_union

    xd.compute_heatmaps(spec, model, padded, ["ig"], ig_steps=4)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        xd.compute_heatmaps(spec, model, padded, ["ig"], ig_steps=4)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _intervals_union([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
    dur = [((e.time_range.end - e.time_range.start) / 1e3, e.name.lower()) for e in events]
    total = sum(t for t, _ in dur)
    gemm = sum(t for t, n in dur if "gemm" in n or "cutlass" in n)
    flash = sum(t for t, n in dur if "flash" in n)
    n_grad = 8
    t = (padded.shape[0] // 16) * (padded.shape[1] // 16) + 1
    print(f"explain IG profile ({label} f32, T = {t}, one forward + 8 gradients): wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / wall:.1%}), {len(events) / n_grad:.0f} kernels a gradient; of the device "
          f"time GEMMs {gemm / total:.1%}, flash rows {flash / total:.1%}")


def explain_phase(card, counters, fa, gen):
    """Phase 15 (see the module docstring). Returns (the two kernel rows,
    their launches in the explain-eval run)."""
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.explain import driver as xd
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train import mvh as tmvh

    t_phase = time.time()
    rows = check_flash_explain(fa, gen)
    root = tempfile.mkdtemp(prefix="vipers_torch_explain_")
    try:
        spec = build_model("vit_b_16")
        params, masks = seeded_pruned(spec)
        pth = os.path.join(root, "vit_b_16.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), pth)
        voc = os.path.join(root, "voc")
        # explain-eval scores the first EXPLAIN_EVAL_IMAGES of them (sorted)
        all_sizes = explain_voc(voc)
        sizes = dict(list(all_sizes.items())[:EXPLAIN_EVAL_IMAGES])
        tokens = sorted({(-(-h // 16)) * (-(-w // 16)) + 1 for w, h in sizes.values()})

        # explain-eval: the kernel path
        out = os.path.join(root, "ee")
        torch.cuda.synchronize()
        reset_counts(*counters)
        xd.LAST_RUN.clear()
        t0 = time.perf_counter()
        assert cli(["explain-eval", "--model", "vit_b_16", "--checkpoint", pth,
                    "--voc-root", voc, "--num-images", str(EXPLAIN_EVAL_IMAGES),
                    "--output-dir", out]) == 0
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = len(sizes)
        blocks = spec.cfg.num_layers - 1  # the last block returns its attention: einsum
        want_fwd, want_bwd = n * blocks * (1 + 1 + 2 * 50), n * blocks * 2 * 50
        launches = {"flash_attention_fwd[f32, explain]": fa.LAUNCHES["float32"],
                    "flash_attention_bwd[f32, explain]": fa.BWD_LAUNCHES["float32"]}
        others = all_launches(counters) - sum(launches.values())
        print(f"explain-eval launches: {launches} (want {want_fwd} and {want_bwd}: {n} images "
              f"x {blocks} flash blocks x (forward + GradCAM forward + 100 IG passes) and x 100 "
              f"IG backwards), every other row {others}; T {tokens}")
        assert launches == {"flash_attention_fwd[f32, explain]": want_fwd,
                            "flash_attention_bwd[f32, explain]": want_bwd}, launches
        assert others == 0, [c for c in counters]
        for m in ("gradCAM", "ig", "attention"):
            lines = open(os.path.join(out, f"{m}_vit_b_16_pruning_iteration_00.txt")).read()
            vals = [float(ln.split(":")[-1]) for ln in lines.splitlines()[:2]]
            assert lines.splitlines()[2] == f"On a total of {n} images."
            assert all(0.0 <= v <= 1.0 for v in vals), (m, vals)
            print(f"explain-eval {m}: mass {vals[0]:.4f} rank {vals[1]:.4f} over {n} images")
        per = {k: 1e3 * v / n for k, v in xd.LAST_RUN["method_s"].items()}
        print(f"explain-eval vit_b_16 f32: {n / dt:.3f} img/s e2e ({dt:.1f} s for {n} images; "
              f"ms an image: {', '.join(f'{k} {v:.1f}' for k, v in per.items())}) ({card})")

        # explain: ViT-B/16 with every method, ResNet-50 with the defaults
        data = os.path.join(root, "if")
        imagefolder_tree(data, 8, 8, seed=15)
        try:
            import matplotlib  # noqa: F401
            why = None
        except ImportError as e:
            why = e
        runs = (["--model", "vit_b_16", "--checkpoint", pth, "--methods", "gradcam",
                 "guided_gradcam", "ig", "attention", "lrp"], [])
        for extra in runs:
            name = extra[1] if extra else "resnet50"
            out = os.path.join(root, f"ex_{name}")
            argv = ["explain", *extra, "--data-path", data, "--num-classes-sample", "2",
                    "--output-dir", out]
            torch.cuda.synchronize()
            reset_counts(*counters)
            xd.LAST_RUN.clear()
            t0 = time.perf_counter()
            if why is None:
                assert cli(argv) == 0
                what = "maps and figures"
            else:
                try:
                    cli(argv)
                except ImportError:
                    pass
                else:
                    raise AssertionError("explain ran without matplotlib")
                xd.LAST_RUN.clear()
                explain_without_figures(extra, data, out)
                what = (f"maps only: matplotlib does not import here ({why}), so the CLI "
                        f"failed with that ImportError as vipers explain would; the heatmaps "
                        f"and .npy writes ran through compute_heatmaps")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert all_launches(counters) == 0, counters
            npys = [f for d_, _s, fs in os.walk(out) for f in fs if f.endswith(".npy")]
            files = sum(len(fs) for _d, _s, fs in os.walk(out))
            methods = sorted(os.listdir(out))
            assert len(npys) == 2 * len(methods), (npys, methods)
            per = {k: 1e3 * v / 2 for k, v in xd.LAST_RUN["method_s"].items()}
            print(f"explain {name}: 2 classes, {methods}, {files} files ({what}), "
                  f"{dt:.1f} s; ms an image: "
                  f"{', '.join(f'{k} {v:.1f}' for k, v in per.items())}; 0 launches")

        # card against CPU at the fixture's flattest image, 500x281 -> 512x288 (T = 577)
        stem = min(all_sizes, key=lambda s_: all_sizes[s_][1])
        _s, card_model = xd._load_model("vit_b_16", pth)
        _s, cpu_model = xd._load_model("vit_b_16", pth, device="cpu")
        explain_card_vs_cpu(spec, card_model, cpu_model, voc, stem)
        del card_model, cpu_model

        # mvh: ResNet-50 and ViT-B/16, 1 batch of 1 image at 224
        for model in ("resnet50", "vit_b_16"):
            out = os.path.join(root, f"mvh_{model}")
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            assert cli(["mvh", "--model", model, "--data-path", data, "--batch-size", "1",
                        "--max-batches", "1", "--workers", "2", "--pruning-step", "1",
                        "--output-dir", out]) == 0
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert all_launches(counters) == 0, counters
            csv = open(os.path.join(out, f"{model}_pruning_step_1.csv")).read().splitlines()
            assert len(csv) == 20 and csv[1].startswith(f"{model},edge,accuracy (top-1),")
            lr = tmvh.LAST_RUN
            print(f"mvh {model}: CSV 19 rows; {lr['images']} distorted images in {dt:.1f} s "
                  f"({lr['images'] / dt:.1f} img/s e2e): host numpy distortions "
                  f"{lr['distort_s']:.1f} s ({lr['distort_s'] / dt:.0%}), eval steps "
                  f"{lr['eval_s']:.1f} s; 0 launches ({card})")
    finally:
        remove_later(root)
    print(f"phase 15 explain and mvh: {time.time() - t_phase:.1f} s")
    return rows, launches


def explain_without_figures(extra, data, out):
    """``explain``'s maps and ``.npy`` writes without its figures, through
    ``compute_heatmaps`` (for a machine where matplotlib does not import)."""
    from vipers_torch.cli.main import build_parser
    from vipers_torch.data.imagefolder import ImageFolder
    from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, eval_decode
    from vipers_torch.explain import driver as xd

    args = build_parser().parse_args(["explain", *extra, "--data-path", data])
    spec, model = xd._load_model(args.model, args.checkpoint)
    ds = ImageFolder(os.path.join(data, "val"))
    seen = set()
    for path, label in ds.samples:
        if label in seen or len(seen) == 2:
            continue
        seen.add(label)
        arr = eval_decode(path).astype(np.float32) / 255.0
        img = ((arr - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)
        for method, hm in xd.compute_heatmaps(spec, model, img, args.methods).items():
            if method != "prediction":
                d = os.path.join(out, method, ds.classes[label])
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, f"{os.path.basename(path)}_nparray.npy"), hm)


# Phase 16: the DINO ViTs through LOST (--arch dino, --dinoseg) and cluster,
# VGG16 training with its dropout, the ViT's attention dropout.
DINO_P8_BATCH = 32  # dino_vit_small at patch 8: T = 3073 seq-padded to 3200
DINO_CPU_LAYERS, DINO_CPU_BATCH = 2, 2  # the card-vs-CPU cut
N_DINOSEG, N_DINOSEG_CPU = 32, 2  # --dinoseg JPEGs, and those the CPU runs too
N_CLUSTER_BOXES = 32  # of the lost run's boxes, clustered on the card and on the CPU
VGG_CUT_BATCH = 2  # the f32 card-vs-CPU VGG16 steps
DROPOUT_STEP_BATCH = 32  # the ViT-B/16 steps under attention dropout


def dino_model(name, patch=PATCH):
    """A DINO backbone of the registry at ``patch`` (``num_classes`` 0, the
    pos table at 224x224, interpolated to each bucket by the extractor),
    random weights from seed 0 moved to the card. Returns (spec, params)."""
    from vipers_torch.core.registry import build_model

    t0 = time.time()
    spec = build_model(name, patch_size=patch)
    params = to_device(seeded_init(spec), "cuda")
    c = spec.cfg
    print(f"{name} patch {patch} ({c.depth} blocks, D {c.embed_dim}, {c.num_heads} heads of "
          f"{c.embed_dim // c.num_heads}, mlp {int(c.embed_dim * c.mlp_ratio)}): random weights "
          f"from seed 0 (set-up {time.time() - t0:.1f} s)")
    return spec, params


def cut_dino(spec, params, layers):
    """A DINO ``spec`` cut to its first ``layers`` blocks at full width, the
    same weights."""
    import dataclasses

    from vipers_torch.models.dino_vit import _build

    cut = _build(spec.name, dataclasses.replace(spec.cfg, depth=layers))
    return cut, {k: v for k, v in params.items()
                 if not k.startswith("block_") or int(k[len("block_"):]) < layers}


def voc_subset(src, dst, names):
    """A VOC07-layout tree at ``dst`` holding ``names`` of the tree ``src``
    (JPEG and annotation symlinks)."""
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(dst, sub))
    for n in names:
        for sub, ext in (("JPEGImages", "jpg"), ("Annotations", "xml")):
            os.symlink(os.path.realpath(os.path.join(src, sub, f"{n}.{ext}")),
                       os.path.join(dst, sub, f"{n}.{ext}"))
    with open(os.path.join(dst, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{n}\n" for n in names))


def dino_lost(card, counters, gen, lost_core):
    """The DINO backbones through the batched LOST pipeline, full width,
    random weights from seed 0, on 512x384 uint8 images: dino_vit_small at
    patch 16 in f32 and bf16 on an exact-fit and a mixed bucket (a batch:
    12 flash launches, and in bf16 12 fused-MLP launches at D = 384),
    img/s at B=128 and p50 at B=1, card vs CPU on its first
    DINO_CPU_LAYERS blocks at B=DINO_CPU_BATCH (f32 features within 1e-3
    of their scale, boxes equal up to ties); dino_vit_tiny (D = 192) and
    dino_vit_base (D = 768) in bf16 (launches, img/s, row 1 at their 3 and
    12 heads), row 4 at D = 192;
    dino_vit_small at patch 8 in bf16 at B=DINO_P8_BATCH (T = 3073 ->
    3200: 12 flash and 12 fused-MLP launches), img/s, and row 1 at that T.
    Returns (kernel rows, {row name: launches})."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    rows, launches = [], {}
    spec, params = dino_model("dino_vit_small")
    n = spec.cfg.depth
    extractors, buckets, inputs, pipes, outs, got = family_pipelines(
        "dino_vit_small", spec, params, None, (H, W), ("f32", "bf16"), counters,
        {"flash[float32]": 2 * n, "flash[bfloat16]": 2 * n, "fused_mlp[D=384]": 2 * n}, seed=11)
    print(f"dino_vit_small a batch: bf16 {got['flash[bfloat16]'] // 2} flash and "
          f"{got['fused_mlp[D=384]'] // 2} fused-MLP launches, f32 {got['flash[float32]'] // 2} "
          f"flash and 0 fused-MLP launches")
    agree = {b: float((outs["f32", b][0] == outs["bf16", b][0]).all(dim=1).float().mean())
             for b in buckets}
    print(f"dino_vit_small bf16 vs f32 on the card: boxes equal on {agree}")
    for e, ex in extractors.items():
        imgs, bhw = buckets["exact"]
        ips, p50 = throughput(pipes[e], inputs[e, "exact"],
                              ex.prepare_batch(imgs[:1], PATCH, exact_hw=bhw[:1]))
        print(f"dino_vit_small throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{p50:.2f} ms at B=1 ({card})")
    del extractors, inputs, pipes, outs
    torch.cuda.empty_cache()
    cut, cut_params = cut_dino(spec, params, DINO_CPU_LAYERS)
    print(f"dino_vit_small card vs CPU: cut to its first {DINO_CPU_LAYERS} of {n} blocks and "
          f"B={DINO_CPU_BATCH} (the CPU's time), f32")
    ex = LostFeatureExtractor(cut, cut_params, None)
    for b in ("exact", "mixed"):
        imgs, bhw = buckets[b]
        lo = 8 if b == "mixed" else 0  # the mixed bucket's first 8 fill it exactly
        compare_with_cpu(f"dino_vit_small f32, {b}", cut, cut_params, None, torch.float32, ex,
                         imgs[lo:lo + DINO_CPU_BATCH], bhw[lo:lo + DINO_CPU_BATCH], lost_core,
                         n_cpu=DINO_CPU_BATCH)
    del ex, params, cut_params
    torch.cuda.empty_cache()

    for name, d, seed in (("dino_vit_tiny", 192, 12), ("dino_vit_base", 768, 13)):
        spec, params = dino_model(name)
        n = spec.cfg.depth
        extractors, buckets, inputs, pipes, _, got = family_pipelines(
            name, spec, params, None, (H, W), ("bf16",), counters,
            {"flash[bfloat16]": 2 * n, f"fused_mlp[D={d}]": 2 * n}, seed=seed)
        launches[f"flash_attention_fwd[bf16, H={spec.cfg.num_heads}]"] = got["flash[bfloat16]"]
        if d == 192:
            launches["fused_ln_fc1_gelu[bf16, D=192]"] = got["fused_mlp[D=192]"]
            print(f"dino_vit_tiny a bf16 batch: {got['fused_mlp[D=192]'] // 2} fused-MLP launches "
                  f"at D = 192 (instance {fused_mlp_design(fm, 192)})")
        imgs, bhw = buckets["exact"]
        ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                              extractors["bf16"].prepare_batch(imgs[:1], PATCH,
                                                               exact_hw=bhw[:1]))
        print(f"{name} throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
              f"at B=1 ({card})")
        del extractors, inputs, pipes, params
        torch.cuda.empty_cache()
        # row 1 at this model's heads, the pipeline's shape (769 tokens -> 896)
        rows.append(check_flash_at(fa, torch.bfloat16, gen, (BATCH, spec.cfg.num_heads, 896, 64),
                                   (H // PATCH, W // PATCH), (29, 22), f"H={spec.cfg.num_heads}"))
        torch.cuda.empty_cache()
    rows += check_fused_mlp_family(fm, gen, shapes=((192, BATCH * 896),))

    # patch 8: T = 3073 at 512x384
    spec, params = dino_model("dino_vit_small", 8)
    n = spec.cfg.depth
    ex = LostFeatureExtractor(spec, params, None, compute_dtype=torch.bfloat16)
    hw8 = [(H, W)] * DINO_P8_BATCH
    imgs = make_images(np.random.default_rng(14), hw8, patch=8)
    inp = ex.prepare_batch(imgs, 8, exact_hw=hw8)
    pipe = ex.make_batched_pipeline(K_PATCHES)
    torch.cuda.synchronize()
    reset_counts(*counters)
    box, seed, bg = (z.cpu() for z in pipe(*inp))
    torch.cuda.synchronize()
    got = family_launches(fa, fm, at)
    want = {"flash[bfloat16]": n, "fused_mlp[D=384]": n}
    print(f"dino_vit_small patch 8 LOST path launches (one bf16 forward of {n} blocks, "
          f"T = {(H // 8) * (W // 8) + 1} -> 3200, B={DINO_P8_BATCH}): "
          f"{ {k: v for k, v in got.items() if v} }")
    assert got == {k: want.get(k, 0) for k in got}, (got, want)
    gh, gw = H // 8, W // 8
    assert bool(((box[:, 0] <= box[:, 1]) & (box[:, 1] <= gh)
                 & (box[:, 2] <= box[:, 3]) & (box[:, 3] <= gw)).all())
    assert bool(((seed >= 0) & (seed < gh * gw)).all())
    launches["flash_attention_fwd[bf16, T=3200]"] = got["flash[bfloat16]"]
    ips, p50 = throughput(pipe, inp, ex.prepare_batch(imgs[:1], 8, exact_hw=hw8[:1]))
    print(f"dino_vit_small patch 8 throughput [bf16] {ips:.1f} img/s at B={DINO_P8_BATCH}; p50 "
          f"latency {p50:.2f} ms at B=1; seed in background {int(bg.sum())}/{DINO_P8_BATCH} "
          f"({card})")
    del ex, inp, pipe, params
    torch.cuda.empty_cache()
    rows.append(check_flash_at(fa, torch.bfloat16, gen, (DINO_P8_BATCH, 6, 3200, 64), (gh, gw),
                               (56, 44), "T=3200"))
    torch.cuda.empty_cache()
    return rows, launches


def dino_cli(card, counters, gen):
    """``vipers_torch lost --arch dino --model dino_vit_small --dtype bf16``
    on N_LOST_IMAGES fixture JPEGs from a seed-0 .pth in
    facebookresearch/dino's keys (12 flash and 12 fused-MLP launches a
    batch, the first batch against the pipeline, the txt against
    ``corloc``, e2e img/s); ``--dinoseg`` with ``--arch dino`` and with
    ``--arch vit --model vit_s_16`` on N_DINOSEG of them, f32 one image at a
    time (11 flash launches an image: the last block computes its
    attention), per-image img/s, the boxes of the first N_DINOSEG_CPU equal
    to a CPU run's; ``vipers_torch cluster --nb-clusters 20`` on the
    lost run's preds.pkl (crops/s; no kernel launch), its embeddings
    within 1e-4 of their scale of a CPU run's and the labels equal (the
    same initial points). Row 1 at the --dinoseg shape: f32, B*H = 1*6,
    T = 769 (a 500x375 image's 31x23 grid on its 32x24 bucket), no
    sequence pad. Returns (kernel rows, {row name: launches})."""
    import pickle
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import (export_dino_vit, export_vit_torchvision,
                                              save_torch_state_dict)
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery import cluster as clu
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    if not native.available() and not native.pil_available():
        print("DINO JPEG LOST and cluster: neither libjpeg nor PIL on the host: skipped")
        return [], {}
    seg_launches = 0
    root = tempfile.mkdtemp(prefix="vipers_torch_dino_")
    try:
        voc = os.path.join(root, "VOC2007")
        items = voc_tree(voc, N_LOST_IMAGES, seed=3)
        dino_pth = os.path.join(root, "dino_vit_small.pth")
        save_torch_state_dict(export_dino_vit(build_model("dino_vit_small").init(
            torch.Generator().manual_seed(0))), dino_pth)
        common = ["--dataset", "VOC07", "--set", "trainval", "--workers", "8"]

        # lost --arch dino, bf16, B=128
        out = os.path.join(root, "lost")
        batches = cli_batches(items)
        torch.cuda.synchronize()
        reset_counts(*counters)
        assert cli(["lost", "--arch", "dino", "--model", "dino_vit_small", "--patch-size", "16",
                    *common, "--data-path", voc, "--checkpoint", dino_pth, "--dtype", "bf16",
                    "--batch-size", str(BATCH), "--output-dir", out]) == 0
        torch.cuda.synchronize()
        run = dict(drv.LAST_RUN)
        got = family_launches(fa, fm, at)
        want = {"flash[bfloat16]": 12 * batches, "fused_mlp[D=384]": 12 * batches}
        print(f"dino_vit_small JPEG LOST [bf16] {N_LOST_IMAGES} images, {batches} batches: "
              f"launches { {k: v for k, v in got.items() if v} }")
        assert got == {k: want.get(k, 0) for k in got}, (got, want)
        assert run["images"] == N_LOST_IMAGES and run["batches"] == batches, run
        check_first_batch("dino_vit_small bf16", dino_pth, voc, items, out, run["failed"], "bf16",
                          model="dino_vit_small")
        rescored, txt = check_cli_outputs("dino_vit_small", out, voc, "trainval", items,
                                          run["failed"])
        print(f"dino_vit_small JPEG LOST [bf16] e2e "
              f"{N_LOST_IMAGES / run['decode_to_preds_seconds']:.1f} img/s (first decode to "
              f"preds.pkl {run['decode_to_preds_seconds']:.3f} s; {run['seconds']:.3f} s with "
              f"the model load); seed in background {len(run['failed'])}; re-scored {rescored}, "
              f"results txt {txt.strip()}; decoder {run['decoder']} ({card})")

        # --dinoseg, one image at a time, f32; the CPU on the first images
        names = [nm for nm, _ in items]
        seg, seg_cpu = os.path.join(root, "VOC_seg"), os.path.join(root, "VOC_seg_cpu")
        voc_subset(voc, seg, names[:N_DINOSEG])
        voc_subset(voc, seg_cpu, names[:N_DINOSEG_CPU])
        vit_pth = os.path.join(root, "vit_s_16.pth")
        save_torch_state_dict(export_vit_torchvision(build_model("vit_s_16").init(
            torch.Generator().manual_seed(0))), vit_pth)
        for arch, model, pth in (("dino", "dino_vit_small", dino_pth),
                                 ("vit", "vit_s_16", vit_pth)):
            argv = ["lost", "--arch", arch, "--model", model, "--dinoseg", *common,
                    "--checkpoint", pth]
            seg_out, cpu_out = os.path.join(root, f"seg_{arch}"), os.path.join(root, f"cpu_{arch}")
            torch.cuda.synchronize()
            reset_counts(*counters)
            assert cli([*argv, "--data-path", seg, "--output-dir", seg_out]) == 0
            torch.cuda.synchronize()
            run = dict(drv.LAST_RUN)
            got = family_launches(fa, fm, at)
            want = {"flash[float32]": 11 * N_DINOSEG}
            assert got == {k: want.get(k, 0) for k in got}, (arch, got)
            seg_launches += got["flash[float32]"]
            assert run["images"] == N_DINOSEG and run["per_image"] and not run["failed"], run
            rescored, _ = check_cli_outputs(f"dinoseg {arch}", seg_out, seg, "trainval",
                                            items[:N_DINOSEG], [])
            assert cli([*argv, "--data-path", seg_cpu, "--output-dir", cpu_out,
                        "--device", "cpu"]) == 0
            with open(os.path.join(seg_out, "preds.pkl"), "rb") as f:
                card_preds = pickle.load(f)
            with open(os.path.join(cpu_out, "preds.pkl"), "rb") as f:
                cpu_preds = pickle.load(f)
            same = sum(np.array_equal(card_preds[k], v) for k, v in cpu_preds.items())
            print(f"lost --dinoseg --arch {arch} --model {model} f32: {N_DINOSEG} images one at a "
                  f"time, {got['flash[float32]'] // N_DINOSEG} flash launches an image; per-image "
                  f"{N_DINOSEG / run['decode_to_preds_seconds']:.1f} img/s (first decode to "
                  f"preds.pkl); {rescored}; boxes equal to the CPU's on {same}/{len(cpu_preds)} "
                  f"({card})")
            assert same == len(cpu_preds) == N_DINOSEG_CPU

        # cluster the first N_CLUSTER_BOXES boxes of the lost run's preds.pkl,
        # on the card and on the CPU
        with open(os.path.join(out, "preds.pkl"), "rb") as f:
            preds = pickle.load(f)
        preds = dict(list(preds.items())[:N_CLUSTER_BOXES])
        feats, labels = {}, {}
        for dev in ("cuda", "cpu"):
            d = os.path.join(root, f"cluster_{dev}")
            os.makedirs(d)
            with open(os.path.join(d, "preds.pkl"), "wb") as f:
                pickle.dump(preds, f)
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            assert cli(["cluster", "--preds", os.path.join(d, "preds.pkl"), "--data-path", voc,
                        "--checkpoint", dino_pth, "--nb-clusters", "20", "--feature-cache",
                        os.path.join(d, "feats.pkl"), "--device", dev]) == 0
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            run = dict(clu.LAST_RUN)
            with open(os.path.join(d, "feats.pkl"), "rb") as f:
                feats[dev] = np.asarray(pickle.load(f))
            with open(os.path.join(d, "preds_clusters_20.pkl"), "rb") as f:
                labels[dev] = pickle.load(f)
            n_launch = all_launches(counters)
            print(f"cluster [{dev}] {run['crops']} crops: {run['crops'] / run['embed_seconds']:.1f} "
                  f"crops/s (PIL crops {run['crop_seconds']:.3f} s, with the embedding "
                  f"{run['embed_seconds']:.3f} s), k-means {run['kmeans_seconds']:.3f} s, "
                  f"{secs:.3f} s with the model load; {n_launch} kernel launches "
                  f"({card if dev == 'cuda' else 'host CPU'})")
            assert n_launch == 0
        scale = float(np.abs(feats["cpu"]).max())
        err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
        print(f"cluster card vs CPU: embeddings max_abs_err {err:.3e} ({err / scale:.2e} of their "
              f"scale, tol 1e-4); labels equal {labels['cuda'] == labels['cpu']} "
              f"({len(set(labels['cuda'].values()))} clusters)")
        assert err <= 1e-4 * scale and labels["cuda"] == labels["cpu"]
    finally:
        remove_later(root)
    row = check_flash_at(fa, torch.float32, gen, (1, 6, 769, 64), (32, 24), (31, 23), "dinoseg",
                         pad_rows=slice(0, 1))
    return [row], {row["name"]: seg_launches}


def vgg_train(card, counters):
    """VGG16 (full width and depth, 1000 classes, its dropout at 0.5, the
    CLI's seed-42 weights) through ``train --amp --lr 0.01`` at 224x224,
    B=128, 8 decode threads, on phase 12's ImageFolder: SNIP to 50% for one epoch,
    LRR (rate 0.2, threshold 19.9: one iteration of one epoch); no kernel
    launch in either; e2e img/s, the session's step img/s (best of 3
    windows of 6 steps) and the peak device memory. The dropout on the
    card: the keep share of each of the classifier's dropouts within a
    binomial 5-sigma band, kept activations scaled by 2, and a step resumed
    from a checkpoint of the session drawing the session's own masks. Card
    vs CPU: 2 masked f32 SGD steps at dropout rate 0, B=VGG_CUT_BATCH, the
    parameters no farther (relative L2) from an f64 CPU run than 2x the
    CPU's own f32."""
    import json
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import save_train_checkpoint
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.core.metrics import MetricsWriter
    from vipers_torch.models import vgg as tvgg
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train import driver as tdrv
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    root = tempfile.mkdtemp(prefix="vipers_torch_vgg_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, N_TRAIN_IMAGES, N_VAL_IMAGES, seed=4)
        b, m = BATCH, "vgg16"
        # torchvision's VGG recipe: lr 0.01 (at the CLI's 0.1 the BatchNorm-free
        # net diverges within the epoch, in either package)
        common = ["--model", m, "--num-classes", "1000", "--amp", "--batch-size", str(b),
                  "--workers", "8", "--data-path", data, "--epochs", "1", "--print-freq", "4",
                  "--lr", "0.01"]
        steps = N_TRAIN_IMAGES // b
        for method, extra in (("snip", ["--target-sparsity", str(SPARSITY)]),
                              ("magnitude", ["--pruning-rate", "0.2",
                                             "--pruning-threshold", "19.9"])):
            out = os.path.join(root, method)
            torch.cuda.reset_peak_memory_stats()
            secs = run_cli_without_kernels(cli, ["train", *common, "--pruning-method", method,
                                                 *extra, "--output-dir", out], counters)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            run = dict(tdrv.LAST_RUN)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            loss = [r["loss"] for r in recs if r["tag"] == "train"]
            sp = [r["sparsity"] for r in recs if r["tag"] == "prune"]
            assert len(loss) == 1 and np.isfinite(loss[0]), recs
            if method == "magnitude":
                rows = MetricsWriter.read_performance_txt(os.path.join(out, "performance.txt"))
                assert len(rows) == 1, rows
            e2e = steps * b / (run["t_last_checkpoint"] - run["t_first_decode"])
            print(f"train CLI [{method}] {m} bf16 B={b}: {steps} steps, no kernel launch; e2e "
                  f"{e2e:.1f} img/s ({steps * b} images, first decode to the last checkpoint; "
                  f"{secs:.3f} s with the set-up); sparsity {sp}, train loss {loss[0]:.4f}; "
                  f"peak device memory {peak:.2f} GiB ({card})")
            remove_later(out)

        # the session's step, and the dropout on the card
        cfg = TrainConfig(model=m, data_path=data, batch_size=b, workers=8, amp=True,
                          device="cuda", output_dir=os.path.join(root, "step"),
                          optim=OptimConfig(lr=0.01, epochs=1))
        s = tdrv.build_session(cfg)
        images, labels = next(iter(tdrv._train_loader(s, 0)))
        x = s.normalize(images)
        reset_counts(*counters)
        s.train_step(s.state, (x, labels))
        torch.cuda.synchronize()
        assert all_launches(counters) == 0
        best = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(6):
                s.train_step(s.state, (x, labels))
            torch.cuda.synchronize()
            best = max(best, b * 6 / (time.perf_counter() - t1))
        print(f"train CLI session step {m} 224x224 bf16 {best:.1f} img/s at B={b} ({card})")
        path = os.path.join(root, "resume.pth")
        save_train_checkpoint(path, s.state, 0, 0.0)
        s2 = tdrv.build_session(cfg)
        tdrv.resume_session(s2, path)
        assert s2.state.step == s.state.step
        seen = []
        for sess in (s, s2):
            cl, got = sess.state.model.classifier, {}
            hooks = [cl[i].register_forward_hook(
                lambda mod, a, o, i=i: got.__setitem__(i, o.detach().clone())) for i in (2, 5)]
            hooks += [cl[i].register_forward_pre_hook(
                lambda mod, a, i=i: got.__setitem__(i, a[0].detach().clone())) for i in (3, 6)]
            sess.train_step(sess.state, (x, labels))
            for h in hooks:
                h.remove()
            seen.append(got)
        for before, after in ((2, 3), (5, 6)):
            live = seen[0][before] != 0
            kept = seen[0][after] != 0
            nl = int(live.sum())
            share = int(kept[live].sum()) / nl
            band = 5 * (0.25 / nl) ** 0.5
            scaled = torch.equal(seen[0][after][kept], 2 * seen[0][before][kept])
            both = live & (seen[1][before] != 0)
            same = torch.equal(kept[both], (seen[1][after] != 0)[both])
            print(f"{m} dropout {before // 3 + 1} on the card: keep share {share:.4f} of {nl} "
                  f"live activations (0.5 +- {band:.4f}), kept scaled by 2 {scaled}; a step "
                  f"resumed from a checkpoint at step {s.state.step - 1} draws the same mask on "
                  f"{int(both.sum())} activations live in both: {same}")
            assert abs(share - 0.5) <= band and scaled and same and not seen[0][after][~live].any()
        del s, s2, x, seen
        torch.cuda.empty_cache()

        # card vs CPU at dropout rate 0: 2 masked f32 SGD steps, an f64 yardstick
        spec0 = tvgg._spec(m, tvgg.VGGConfig(1000, dropout_rate=0.0), (224, 224))
        params, masks = seeded_pruned(spec0)
        rng = np.random.default_rng(15)
        batches = [(torch.from_numpy(rng.normal(size=(VGG_CUT_BATCH, 224, 224, 3))
                                     .astype(np.float32)),
                    torch.from_numpy(rng.integers(0, 1000, VGG_CUT_BATCH))) for _ in range(2)]
        res = {}
        for run, dev in (("cuda", "cuda"), ("cpu", "cpu"), ("f64", "cpu")):
            t0 = time.time()
            st = create_train_state(spec0, params, masks, OptimConfig(lr=0.01, epochs=1), 1,
                                    device=dev)
            if run == "f64":
                st.model.to(torch.float64)
            step = make_train_step(1000, seed=0)
            for xb, yb in batches:
                st, metrics = step(st, (xb.to(dev), yb.to(dev)))
            res[run] = ({k: v.detach().cpu() for k, v in st.params.items()},
                        float(metrics["loss"]), time.time() - t0)
            del st
        d_card, d_cpu = (rel_l2(res[r][0], res["f64"][0]) for r in ("cuda", "cpu"))
        print(f"train {m} f32 B={VGG_CUT_BATCH}, dropout rate 0, 2 masked SGD steps: parameters "
              f"relative L2 from the CPU's f64 run: the card's {d_card:.3e}, the CPU's f32 "
              f"{d_cpu:.3e} (the card's within 2x of it); last losses card "
              f"{res['cuda'][1]:.6f}, CPU {res['cpu'][1]:.6f}, f64 {res['f64'][1]:.6f}; "
              f"seconds card {res['cuda'][2]:.1f}, CPU {res['cpu'][2]:.1f}, f64 "
              f"{res['f64'][2]:.1f} ({card})")
        assert d_card <= 2 * d_cpu, (d_card, d_cpu)
    finally:
        remove_later(root)


def vit_attention_dropout(card, counters):
    """A bf16 ViT-B/16 train step (1000 classes, seed-0 weights,
    B=DROPOUT_STEP_BATCH) at 224x224 and 384x384 with
    ``attention_dropout_rate`` 0.1: no launch of rows 1, 5-8 and 12-13 (the
    attention keeps its probabilities for the dropout); at rate 0 the
    launches of phases 12 (224: 12 training forward and backward) and 8
    (384: 12 flash forward and backward). Finite losses; ms a step."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    b = DROPOUT_STEP_BATCH
    g = torch.Generator(device="cuda").manual_seed(0)
    for hw, want0 in ((TRAIN_HW, ("attention_train_fwd[bf16]", "attention_train_bwd[bf16]")),
                      (TRAIN_HW_FLASH, ("flash_attention_fwd[bf16]",
                                        "flash_attention_bwd[bf16]"))):
        params = build_model("vit_b_16", image_size=(hw, hw)).init(
            torch.Generator().manual_seed(0))
        x = torch.randn(b, hw, hw, 3, generator=g, device="cuda")
        y = torch.randint(0, 1000, (b,), generator=g, device="cuda")
        for rate in (0.1, 0.0):
            spec = build_model("vit_b_16", image_size=(hw, hw), attention_dropout_rate=rate)
            state = create_train_state(spec, params, {}, OptimConfig(lr=0.01, epochs=1), 1,
                                       device="cuda")
            step = make_train_step(1000, compute_dtype=torch.bfloat16, seed=0)
            step(state, (x, y))
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            state, metrics = step(state, (x, y))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            got = train_launches(at, fa, fm)
            want = {} if rate else {k: spec.cfg.num_layers for k in want0}
            print(f"vit_b_16 {hw}x{hw} bf16 train step, attention dropout {rate}, B={b}: "
                  f"launches { {k: v for k, v in got.items() if v} }, loss "
                  f"{float(metrics['loss']):.4f}, {ms:.1f} ms ({card})")
            assert got == {k: want.get(k, 0) for k in got}, (hw, rate, got)
            assert np.isfinite(float(metrics["loss"]))
            del state
        del params, x, y
        torch.cuda.empty_cache()


def dino_phase(card, counters, gen, lost_core):
    """Phase 16: ``dino_lost``, ``dino_cli``, ``vgg_train`` and
    ``vit_attention_dropout``. Returns (kernel rows, {row name: launches})."""
    t_phase = time.time()
    rows, launches = dino_lost(card, counters, gen, lost_core)
    cli_rows, cli_launches = dino_cli(card, counters, gen)
    rows += cli_rows
    launches.update(cli_launches)
    vgg_train(card, counters)
    vit_attention_dropout(card, counters)
    print(f"phase 16 DINO LOST, cluster and dropout: {time.time() - t_phase:.1f} s")
    return rows, launches


SLIM_TRAIN_BATCH = 64  # the ViT-B/16 slim fine-tune: 2 steps of 64 at 224
SLIM_TRAIN_IMAGES, SLIM_VAL_IMAGES = 128, 64
SLIM_CNN_VAL = 16  # val images of the CNN and Swin slim evaluate runs


def synthetic_voc(root, n, hw, seed):
    """A VOC07-layout tree of ``n`` synthetic ``hw`` (h, w) JPEGs (PIL,
    quality 90), textured noise with a bright block, one box an image.
    Returns [(name, (w, h))]."""
    from PIL import Image

    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = hw
    items = []
    for i, im in enumerate(make_images(np.random.default_rng(seed), [hw] * n)):
        name = f"{i:06d}"
        Image.fromarray(im[:h, :w]).save(os.path.join(root, "JPEGImages", f"{name}.jpg"),
                                        quality=90)
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width>"
                    f"<height>{h}</height><depth>3</depth></size><object><name>thing</name>"
                    f"<truncated>0</truncated><difficult>0</difficult><bndbox><xmin>1</xmin>"
                    f"<ymin>1</ymin><xmax>{w // 2}</xmax><ymax>{h // 2}</ymax></bndbox>"
                    f"</object></annotation>")
        items.append((name, (w, h)))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name, _ in items))
    return items


def exact_slim_masks(spec, params):
    """A 50% global magnitude mask, then in every block the fc2 rows of the
    even MLP neurons and the out-projection rows of heads 1 and 4 zero: the
    inert units ``slim --mlp-keep 0.5 --heads-keep 0.5`` drops, so that
    slim is exact."""
    from vipers_torch.pruning import init_masks, magnitude_prune

    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                            amount=SPARSITY)
    hd = spec.cfg.hidden_dim // spec.cfg.num_heads
    for i in range(spec.cfg.num_layers):
        fc2 = (f"encoder_layer_{i}", "mlp", "fc2", "kernel")
        out = (f"encoder_layer_{i}", "attention", "out", "kernel")
        masks[fc2] = masks[fc2].clone()
        masks[fc2][0::2] = False
        masks[out] = masks[out].clone()
        for a in (1, 4):
            masks[out][a * hd:(a + 1) * hd] = False
    return masks


def check_fused_mlp_slim(fm, gen, f, m=BATCH * 896, d=384):
    """Row 4 at a slimmed ViT-S/16's MLP width ``f`` (M = 128*896, D =
    384) against its plain version (2e-2 of the output scale), timed beside
    the library's sequence, with the bound."""
    x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
    out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
    want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
    torch.cuda.synchronize()
    err, sc = scaled_err(out, want)
    del out, want
    ms, lib_ms, bms, by, line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)
    plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6),
                       reps=3, warmup=1)
    name = f"fused_ln_fc1_gelu[bf16, slim F={f}]"
    print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {sc:.3g}) {line} plain "
          f"{plain_ms:.3f} ms at M = {m}, D = {d}")
    return {"name": name, "route": "cuda", "source": "vipers_torch/csrc/fused_mlp.cu",
            "replaces": "vipers/ops/fused_mlp.py:123", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "design": fm.design(d)}


def slim_lost(card, counters, gen):
    """ViT-S/16 at full width (seed 0, ``exact_slim_masks``) as a reference
    .pth, slimmed by ``vipers_torch slim`` twice: ``--mlp-keep 0.5
    --heads-keep 0.5`` (exact; F = 768, 4 heads) and ``--round-to 1
    --mlp-keep 0.3 --heads-keep 0.5`` (F = 461, 3 heads); each through
    ``vipers_torch lost --arch vit`` at B=128 on 128 synthetic 512x384
    JPEGs in bf16 and f32 (12 flash launches a batch, 12 fused MLP in
    bf16; the txt against ``corloc``; e2e img/s). Rows 1 and 4 at these
    shapes against their plain versions; the exact slim's f32 features on
    the card against the masked dense model's (1e-4 of their scale), boxes
    agreeing counted; ``tools.bench_slim``'s dense-vs-slim img/s. Returns
    (kernel rows, {row name: launches})."""
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning.structured import arch_sidecar
    from vipers_torch.tools import bench_slim

    rows, launches = [], {}
    for f in (768, 461):
        rows.append(check_fused_mlp_slim(fm, gen, f))
        torch.cuda.empty_cache()
    for h in (4, 3):
        for dt in (torch.float32, torch.bfloat16):
            rows.append(check_flash_at(fa, dt, gen, (BATCH, h, 896, 64), (32, 24), (29, 22),
                                       f"slim H={h}"))
            torch.cuda.empty_cache()
    if not native.available() and not native.pil_available():
        print("slim JPEG LOST: neither libjpeg nor PIL on the host: skipped")
        return rows, launches
    root = tempfile.mkdtemp(prefix="vipers_torch_slim_")
    try:
        spec = build_model("vit_s_16")
        params = spec.init(torch.Generator().manual_seed(0))
        masks = exact_slim_masks(spec, params)
        dense = os.path.join(root, "vit_s_16.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), dense)
        slims = {}
        for tag, extra, want in (
                ("m768_h4", ["--mlp-keep", "0.5", "--heads-keep", "0.5"],
                 {"mlp_dim": 768, "num_heads": 4, "head_dim": 64}),
                ("m461_h3", ["--round-to", "1", "--mlp-keep", "0.3", "--heads-keep", "0.5"],
                 {"mlp_dim": 461, "num_heads": 3, "head_dim": 64})):
            t0 = time.perf_counter()
            assert cli(["slim", "--model", "vit_s_16", "--checkpoint", dense, *extra,
                        "--output-dir", root]) == 0
            slims[tag] = os.path.join(root, f"vit_s_16_slim_{tag}.pth")
            assert arch_sidecar(slims[tag]) == want, arch_sidecar(slims[tag])
            print(f"slim vit_s_16 -> {tag} {want}: {time.perf_counter() - t0:.1f} s (host numpy)")
        voc = os.path.join(root, "VOC2007")
        items = synthetic_voc(voc, BATCH, (H, W), seed=17)
        for tag, pth in slims.items():
            heads, f = arch_sidecar(pth)["num_heads"], arch_sidecar(pth)["mlp_dim"]
            for dt in ("bf16", "f32"):
                out = os.path.join(root, f"lost_{tag}_{dt}")
                torch.cuda.synchronize()
                reset_counts(*counters)
                assert cli(["lost", "--arch", "vit", "--model", "vit_s_16", "--dataset", "VOC07",
                            "--set", "trainval", "--workers", "8", "--data-path", voc,
                            "--checkpoint", pth, "--dtype", dt, "--batch-size", str(BATCH),
                            "--output-dir", out]) == 0
                torch.cuda.synchronize()
                run = dict(drv.LAST_RUN)
                got = family_launches(fa, fm, at)
                key = "bfloat16" if dt == "bf16" else "float32"
                want = {f"flash[{key}]": 12, "fused_mlp[D=384]": 12 if dt == "bf16" else 0}
                assert got == {k: want.get(k, 0) for k in got}, (tag, dt, got)
                assert run["images"] == BATCH and run["batches"] == 1, run
                rescored, _txt = check_cli_outputs(f"slim {tag} {dt}", out, voc, "trainval",
                                                   items, run["failed"])
                launches[f"flash_attention_fwd[{dt}, slim H={heads}]"] = got[f"flash[{key}]"]
                if dt == "bf16":
                    launches[f"fused_ln_fc1_gelu[bf16, slim F={f}]"] = got["fused_mlp[D=384]"]
                print(f"slim JPEG LOST [{tag}, {dt}] B={BATCH}: launches "
                      f"{ {k: v for k, v in got.items() if v} }; e2e "
                      f"{BATCH / run['decode_to_preds_seconds']:.1f} img/s (first decode to "
                      f"preds.pkl {run['decode_to_preds_seconds']:.3f} s); seed in background "
                      f"{len(run['failed'])}; {rescored}; decoder {run['decoder']} ({card})")

        # exactness on the card: the exact slim's f32 features and boxes
        # against the masked dense model's, on one uint8 batch
        from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint

        slim_spec = build_model("vit_s_16", arch_overrides=arch_sidecar(slims["m768_h4"]))
        sp, _bs, sm, _ = load_lost_checkpoint(slims["m768_h4"], slim_spec)
        hw = [(H, W)] * BATCH
        imgs = make_images(np.random.default_rng(5), hw)
        exs = {"dense": LostFeatureExtractor(spec, params, masks),
               "slim": LostFeatureExtractor(slim_spec, sp, sm)}
        feats, boxes = {}, {}
        for k, ex in exs.items():
            inp = ex.prepare_batch(imgs, PATCH, exact_hw=hw)
            feats[k] = ex.batched_features(*inp).float()
            boxes[k] = ex.make_batched_pipeline(K_PATCHES)(*inp)[0]
        scale = feats["dense"].abs().max().item()
        err = (feats["slim"] - feats["dense"]).abs().max().item()
        same = int((boxes["slim"] == boxes["dense"]).all(dim=1).sum())
        print(f"slim exactness on the card [f32, B={BATCH}]: slim (F = 768, 4 heads) vs masked "
              f"dense k features max_abs_err {err:.3e} ({err / scale:.2e} of scale {scale:.3g}; "
              f"tolerance 1e-4 of it); boxes equal {same}/{BATCH} ({card})")
        assert err <= 1e-4 * scale, (err, scale)
        del exs, feats
        torch.cuda.empty_cache()

        # tools.bench_slim: the dense-vs-slim img/s of the batched pipeline
        reset_counts(*counters)
        res = bench_slim.run()
        print(f"bench_slim (vit_s_16 {H}x{W}, B={BATCH}, random 50%-masked weights vs "
              f"slim m768 h4): {json.dumps(res)} ({card})")
        assert all(res[d]["dense_masked"] > 0 and res[d]["slim"] > 0 for d in ("bf16", "f32"))
    finally:
        remove_later(root)
    return rows, launches


def slim_finetune(card, counters, gen):
    """ViT-B/16 (seed 0, 50% global magnitude mask) as
    ``vit_b_16_epoch_0_pruning_iteration_00.pth``, slimmed by ``slim
    --mlp-keep 0.5 --heads-keep 0.5`` (mlp 1536, 6 heads); ``train --amp
    --resume <slim>.pth`` SNIP to 50% and one epoch of 2 steps of 64 at
    224 (rows 7-8 at 6 heads: 12 launches each a step; no fused MLP: the
    eval batch's 64 * 197 rows fail the JAX block rule; every checkpoint
    carries the sidecar); ``evaluate``
    over the sweep holding the dense and the slim checkpoint (2 rows, no
    launch: f32). Rows 7-8 at the step's B*H = 64*6 against their plain
    versions. Returns (kernel rows, {row name: launches})."""
    import contextlib
    import io
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.pruning.structured import arch_sidecar

    rows = check_attention_train(at, gen, shape=(SLIM_TRAIN_BATCH, 6, 256, 64), n_valid=197,
                                 ragged=120, tag="slim H=6")
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vipers_torch_slim_ft_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, SLIM_TRAIN_IMAGES, SLIM_VAL_IMAGES, seed=6)
        sweep = os.path.join(root, "sweep")
        os.makedirs(sweep)
        spec = build_model("vit_b_16")
        params, masks = seeded_pruned(spec)
        dense = os.path.join(sweep, "vit_b_16_epoch_0_pruning_iteration_00.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), dense)
        t0 = time.perf_counter()
        assert cli(["slim", "--model", "vit_b_16", "--checkpoint", dense, "--mlp-keep", "0.5",
                    "--heads-keep", "0.5", "--output-dir", sweep]) == 0
        slim = os.path.join(sweep, "vit_b_16_slim_m1536_h6.pth")
        arch = {"mlp_dim": 1536, "num_heads": 6, "head_dim": 64}
        assert arch_sidecar(slim) == arch
        print(f"slim vit_b_16 -> {arch}: {time.perf_counter() - t0:.1f} s (host numpy)")
        steps = SLIM_TRAIN_IMAGES // SLIM_TRAIN_BATCH
        evals = -(-SLIM_VAL_IMAGES // SLIM_TRAIN_BATCH)
        out = os.path.join(root, "ft")
        got, secs = train_cli(cli, ["train", "--model", "vit_b_16", "--num-classes", "1000",
                                    "--amp", "--batch-size", str(SLIM_TRAIN_BATCH), "--workers",
                                    "8", "--data-path", data, "--epochs", "1", "--print-freq",
                                    "1", "--pruning-method", "snip", "--target-sparsity",
                                    str(SPARSITY), "--resume", slim, "--output-dir", out],
                              counters, at, fa, fm)
        # the eval batch's 64 * 197 rows fail the JAX block rule (a 128
        # multiple), so its MLP takes no fused kernel, as in the JAX package
        want = {"attention_train_fwd[bf16]": 12 * steps, "attention_train_bwd[bf16]": 12 * steps,
                "fused_ln_fc1_gelu[bf16, D=768]": 0, "flash": 0}
        print(f"train --resume <slim> vit_b_16 (6 heads, mlp 1536) bf16 B={SLIM_TRAIN_BATCH}: "
              f"{steps} steps, {evals} eval batch(es), launches {got}, {secs:.1f} s ({card})")
        assert got == want, (got, want)
        written = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
        assert written == ["vit_b_16_checkpoint_snip_0.5.pth", "vit_b_16_epoch_0_snip_0.5.pth"]
        assert all(arch_sidecar(os.path.join(out, n)) == arch for n in written)
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts(*counters)
        with contextlib.redirect_stdout(buf):
            assert cli(["evaluate", "--model", "vit_b_16", "--num-classes", "1000",
                        "--batch-size", str(SLIM_TRAIN_BATCH), "--workers", "8", "--data-path",
                        data, "--models-path", sweep, "--output-dir",
                        os.path.join(root, "eval")]) == 0
        torch.cuda.synchronize()
        assert all_launches(counters) == 0, all_launches(counters)
        evaluated = [ln for ln in buf.getvalue().splitlines() if ": sparsity" in ln]
        print("evaluate [dense + slim vit_b_16]: " + "; ".join(
            os.path.basename(ln) for ln in evaluated))
        assert len(evaluated) == 2 and "slim_m1536_h6" in evaluated[1]
    finally:
        remove_later(root)
    return rows, {r["name"]: got[r["name"].replace(", slim H=6", "")] for r in rows}


def slim_cnn_families(card, counters):
    """ResNet-50 (``--inner-keep 0.5``), VGG16 (``--conv-keep 0.5
    --fc-keep 0.5``) and swin_v2_t (``--mlp-keep 0.5``), seed-0 weights
    written as ``{model}_epoch_0_pruning_iteration_00.pth``, each through
    ``slim`` and ``evaluate`` of the dense and slim checkpoints on
    SLIM_CNN_VAL val images on the card; no port kernel launches."""
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import family, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning.structured import arch_sidecar

    root = tempfile.mkdtemp(prefix="vipers_torch_slim_cnn_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, 8, SLIM_CNN_VAL, seed=7)
        for model, extra in (("resnet50", ["--inner-keep", "0.5"]),
                             ("vgg16", ["--conv-keep", "0.5", "--fc-keep", "0.5"]),
                             ("swin_v2_t", ["--mlp-keep", "0.5"])):
            sweep = os.path.join(root, model)
            os.makedirs(sweep)
            spec = build_model(model)
            sd = family(spec).export_pth(spec.init(torch.Generator().manual_seed(0)), None,
                                         None, True)
            dense = os.path.join(sweep, f"{model}_epoch_0_pruning_iteration_00.pth")
            save_torch_state_dict(sd, dense)
            del sd
            t0 = time.perf_counter()
            slim_s = run_cli_without_kernels(cli, ["slim", "--model", model, "--checkpoint",
                                                   dense, *extra, "--output-dir", sweep],
                                             counters)
            slim = [n for n in os.listdir(sweep) if "_slim_" in n and n.endswith(".pth")]
            assert len(slim) == 1 and arch_sidecar(os.path.join(sweep, slim[0]))
            eval_s = run_cli_without_kernels(
                cli, ["evaluate", "--model", model, "--batch-size", str(SLIM_CNN_VAL),
                      "--workers", "8", "--data-path", data, "--models-path", sweep,
                      "--output-dir", os.path.join(root, f"eval_{model}")], counters)
            with open(os.path.join(root, f"eval_{model}", "performance.txt")) as f:
                n_rows = sum(1 for ln in f.read().splitlines()[1:] if ln.strip())
            assert n_rows == 2, n_rows  # the dense and the slim checkpoint
            print(f"slim {model} {' '.join(extra)} -> {slim[0]} "
                  f"({json.dumps(arch_sidecar(os.path.join(sweep, slim[0])))[:120]}...): "
                  f"{slim_s:.1f} s; evaluate dense + slim on {SLIM_CNN_VAL} images "
                  f"{eval_s:.1f} s, 0 launches ({card})")
    finally:
        remove_later(root)


def slim_phase(card, counters, gen):
    """Phase 17: ``slim_lost``, ``slim_finetune`` and ``slim_cnn_families``.
    Returns (kernel rows, {row name: launches})."""
    t_phase = time.time()
    rows, launches = slim_lost(card, counters, gen)
    ft_rows, ft_launches = slim_finetune(card, counters, gen)
    rows += ft_rows
    launches.update(ft_launches)
    slim_cnn_families(card, counters)
    print(f"phase 17 structured slimming: {time.time() - t_phase:.1f} s")
    return rows, launches


# Phase 18: int8 quantization. The int8 products are library calls (the
# int8 GEMM of torch._int_mm), not kernels of the port: its kernels' rows
# are row 1's at the int8 LOST path's shapes, and row 4 must read 0.
QUANT_BATCHES = "2"  # PTQ calibration batches of 128
QUANT_CPU_ROWS = 2048  # rows of a card GEMM recomputed on the CPU


def int8_accumulators(card):
    """The card's int32 accumulators of ``matmul_int32`` (cuBLASLt int8
    GEMM through ``torch._int_mm``, padded where it refuses the shape) and
    ``conv_int32`` (im2col + GEMM, depthwise per tap) at the int8 paths'
    shapes, on random int8 operands with all-extreme rows (-128 x 127,
    -128 x -128), equal to the CPU's plain versions: GEMMs on
    QUANT_CPU_ROWS sampled rows (a row depends on its own input row only),
    convolutions on the first 2 images of a B=128 call. Any difference
    fails the run."""
    from vipers_torch.train import quantize as tq

    g = torch.Generator(device="cuda").manual_seed(18)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    t0 = time.time()
    calls0 = tq.INT_MM_CALLS[0]
    # (M, K, N): ViT-S/16 and ViT-B/16 at the LOST shape (patch embedding,
    # fc1, fc2, head), mobilenet_v2's classifier (N = 1000) and the
    # padded shapes (M <= 16, K = 9, N % 8 != 0)
    gemms = [(BATCH * 768, 768, 384), (BATCH * 896, 384, 1536), (BATCH * 896, 1536, 384),
             (BATCH, 384, 1000), (BATCH * 896, 768, 3072), (BATCH * 896, 3072, 768),
             (BATCH, 1280, 1000), (7, 9, 12), (16, 24, 1000)]
    for m, k, n in gemms:
        a, w = i8(m, k), i8(n, k)
        a[0], w[0] = -128, 127
        a[1], w[1] = -128, -128
        acc = tq.matmul_int32(a, w)
        rows = torch.unique(torch.cat([torch.arange(min(m, 2), device="cuda"),
                                       torch.randint(0, m, (min(m, QUANT_CPU_ROWS),),
                                                     generator=g, device="cuda")]))
        want = tq.matmul_int32(a[rows].cpu(), w.cpu())
        assert acc.dtype == torch.int32 and torch.equal(acc[rows].cpu(), want), (m, k, n)
    # (name, C, H, O, kernel, stride, pad, dilation, groups) at 224: mobilenet_v2's
    # stem, depthwise (strided and not) and a 1x1; ResNet-50's stem, a 3x3, a
    # strided 1x1 downsample; its dilated 3x3 of the LOST path (dilate 2)
    convs = [("mobilenet stem", 3, 224, 32, 3, 2, 1, 1, 1),
             ("mobilenet depthwise s2", 96, 112, 96, 3, 2, 1, 1, 96),
             ("mobilenet depthwise", 144, 56, 144, 3, 1, 1, 1, 144),
             ("mobilenet 1x1", 144, 56, 24, 1, 1, 0, 1, 1),
             ("resnet50 conv1", 3, 224, 64, 7, 2, 3, 1, 1),
             ("resnet50 3x3", 64, 56, 64, 3, 1, 1, 1, 1),
             ("resnet50 downsample", 512, 28, 1024, 1, 2, 0, 1, 1),
             ("resnet50 dilated 3x3", 512, 24, 512, 3, 1, 2, 2, 1)]
    for name, c, h, o, kk, st, pad, dil, grp in convs:
        xs = i8(BATCH, c, h + 2 * pad, h + 2 * pad)
        w = i8(o, c // grp, kk, kk)
        xs[0] = -128
        w[0] = 127
        acc = tq.conv_int32(xs, w, (st, st), (dil, dil), grp)
        want = tq.conv_int32(xs[:2].cpu(), w.cpu(), (st, st), (dil, dil), grp)
        assert acc.dtype == torch.int32 and torch.equal(acc[:2].cpu(), want), name
    torch.cuda.synchronize()
    print(f"int8 accumulators: {len(gemms)} GEMM shapes (M up to {BATCH * 896}, "
          f"{QUANT_CPU_ROWS} sampled rows each on the CPU) and {len(convs)} convolutions at "
          f"B={BATCH} (2 images on the CPU) equal to the CPU's int32, "
          f"{tq.INT_MM_CALLS[0] - calls0} torch._int_mm calls; {time.time() - t0:.1f} s ({card})")


def int8_lost(card, counters, lost_core):
    """``lost --dtype int8``'s pipeline on full-width ViT-S/16 (seed 0,
    50% global magnitude mask) at 512x384, B=128, dynamic qparams, on an
    exact-fit and a mixed bucket: 12 bf16 flash launches a batch (the
    attention projections stay float), 0 fused-MLP launches, 26
    ``torch._int_mm`` calls a batch (patch embedding, fc1 and fc2 of 12
    blocks, head); img/s at B=128 beside bf16's; the features of the card
    against the CPU's on the model cut to 2 blocks at B=4 (2e-2 of their
    scale: an activation a bf16 ulp apart takes the neighbouring uint8
    bin). Returns the int8 batches' flash launches."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train import quantize as tq

    spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W))
    params, masks = seeded_pruned(spec)
    rng = np.random.default_rng(18)
    exact_hw = [(H, W)] * BATCH
    mixed_hw = [(H, W)] * 8 + [(int(rng.integers(449, H + 1)), int(rng.integers(321, W + 1)))
                               for _ in range(BATCH - 8)]
    buckets = {"exact": (make_images(rng, exact_hw), exact_hw),
               "mixed": (make_images(rng, mixed_hw), mixed_hw)}
    exs = {"int8": LostFeatureExtractor(spec, params, masks, compute_dtype="int8"),
           "bf16": LostFeatureExtractor(spec, params, masks, compute_dtype=torch.bfloat16)}
    layers = spec.cfg.num_layers
    flash = 0
    for b, (imgs, hw) in buckets.items():
        inp = exs["int8"].prepare_batch(imgs, PATCH, exact_hw=hw)
        pipe = exs["int8"].make_batched_pipeline(K_PATCHES)
        torch.cuda.synchronize()
        reset_counts(*counters)
        calls0 = tq.INT_MM_CALLS[0]
        box, seed, bg = (z.cpu() for z in pipe(*inp))
        torch.cuda.synchronize()
        got = {"flash bf16": fa.LAUNCHES["bfloat16"], "fused MLP": fm.LAUNCHES["bfloat16"],
               "every other": all_launches(counters) - fa.LAUNCHES["bfloat16"],
               "_int_mm": tq.INT_MM_CALLS[0] - calls0}
        assert got == {"flash bf16": layers, "fused MLP": 0, "every other": 0,
                       "_int_mm": 2 * layers + 2}, got
        flash += got["flash bf16"]
        gh, gw = H // PATCH, W // PATCH
        assert box.shape == (BATCH, 4) and bool(((box[:, 1] <= gh) & (box[:, 3] <= gw)).all())
        assert bool(((seed >= 0) & (seed < gh * gw)).all())
        feats = exs["int8"].batched_features(*inp)
        assert bool(torch.isfinite(feats).all())
        print(f"int8 LOST [{b}] vit_s_16 B={BATCH}: launches {got} a batch; seed in the "
              f"background {int(bg.sum())}/{BATCH}")
    rates = {}
    imgs, hw = buckets["exact"]
    for tag, ex in exs.items():
        inp = ex.prepare_batch(imgs, PATCH, exact_hw=hw)
        one = ex.prepare_batch(imgs[:1], PATCH, exact_hw=hw[:1])
        rates[tag] = throughput(ex.make_batched_pipeline(K_PATCHES), inp, one)
    print(f"int8 LOST throughput vit_s_16 512x384: int8 {rates['int8'][0]:.1f} img/s "
          f"(p50 {rates['int8'][1]:.2f} ms at B=1), bf16 {rates['bf16'][0]:.1f} img/s "
          f"(p50 {rates['bf16'][1]:.2f} ms) at B={BATCH}; int8/bf16 "
          f"{rates['int8'][0] / rates['bf16'][0]:.3f} ({card})")
    # card vs CPU on the 2-block cut
    cspec, cparams, cmasks = cut_model(spec, params, masks, 2)
    imgs, hw = buckets["mixed"]
    sub, shw = imgs[:N_CPU], hw[:N_CPU]
    card_ex = LostFeatureExtractor(cspec, cparams, cmasks, compute_dtype="int8")
    cpu_ex = LostFeatureExtractor(cspec, cparams, cmasks, compute_dtype="int8", device="cpu")
    gin, cin = (e.prepare_batch(sub, PATCH, exact_hw=shw) for e in (card_ex, cpu_ex))
    gf = card_ex.batched_features(*gin).float().cpu()
    cf = cpu_ex.batched_features(*cin).float()
    scale = cf.abs().max().item()
    err = (gf - cf).abs().max().item()
    gbox, gseed, _ = (z.cpu() for z in card_ex.make_batched_pipeline(K_PATCHES)(*gin))
    cbox, cseed, _ = cpu_ex.make_batched_pipeline(K_PATCHES)(*cin)
    scores = lost_core(cf, cin[3], (gin[0].shape[1] // PATCH, gin[0].shape[2] // PATCH),
                       K_PATCHES)["scores"]
    for i in range(N_CPU):
        if gseed[i] == cseed[i]:
            assert torch.equal(gbox[i], cbox[i]), (i, gbox[i], cbox[i])
        else:  # a tie at the top score
            assert scores[i, gseed[i]] == scores[i, cseed[i]] == scores[i].max(), i
    print(f"int8 LOST card vs CPU (vit_s_16 cut to 2 blocks, B={N_CPU}, mixed bucket): "
          f"features max_abs_err {err:.3e} of scale {scale:.3g} (2e-2 of it allowed), seeds "
          f"equal {int((gseed == cseed).sum())}/{N_CPU}, boxes equal where they are")
    assert err <= 2e-2 * scale, (err, scale)
    return flash


def quantize_cli(cli, argv, counters):
    """One ``vipers_torch quantize`` or ``lost`` run with the counts set to
    0 just before it and read just after: (stdout lines, seconds, {row:
    launches})."""
    import io

    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        assert cli(argv) == 0
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="")
    return (text.splitlines(), secs,
            {"flash bf16": fa.LAUNCHES["bfloat16"], "fused MLP": fm.LAUNCHES["bfloat16"],
             "every": all_launches(counters)})


def quantize_runs(card, counters, vit_b_pth, keep_ptq=None, keep_mb_ptq=None):
    """``vipers_torch quantize --mode ptq`` on phase 12's vit_b_16
    checkpoint (f32, 2 calibration batches of 128 from phase 12's
    ImageFolder), then ``lost --model vit_b_16 --dtype int8`` from the
    ``.pth`` it writes (static qparams from its observers) on 256 JPEGs:
    12 bf16 flash launches a batch, 0 fused MLP; ``quantize --mode ptq``
    and one QAT epoch (2 steps, f32) on quantized_mobilenet_v2 and
    quantized_resnet50 (seed-0 weights, 50% global magnitude masks) at
    224, B=128. No quantize run launches a kernel (f32, T = 197). Checks
    the lines and files; copies the ViT-B/16 PTQ .pth to ``keep_ptq``
    (phase 19 exports it) and quantized_mobilenet_v2's to ``keep_mb_ptq``
    (phase 20's ``lost --dtype int8`` reads it). Returns the int8 lost
    run's flash launches."""
    import pickle
    import shutil
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery import driver as ldrv
    from vipers_torch.discovery.driver import load_lost_checkpoint
    from vipers_torch.pruning import init_masks, magnitude_prune

    root = tempfile.mkdtemp(prefix="vipers_torch_quantize_")
    try:
        data = os.path.join(root, "imagenet")
        imagefolder_tree(data, N_TRAIN_IMAGES, N_VAL_IMAGES, seed=4)
        common = ["--data-path", data, "--num-classes", "1000", "--batch-size", str(BATCH),
                  "--workers", "8", "--calibration-batches", QUANT_BATCHES]
        # 1. PTQ of phase 12's vit_b_16, then lost --dtype int8 from its .pth
        out = os.path.join(root, "vit_b_16")
        lines, secs, got = quantize_cli(cli, ["quantize", "--model", "vit_b_16", "--mode", "ptq",
                                              "--resume", vit_b_pth, "--output-dir", out,
                                              *common], counters)
        assert got["every"] == 0, got
        assert "26 quantizable activation sites" in lines, lines[:5]
        assert any(ln.startswith("PTQ int8: acc1 ") for ln in lines)
        qpth = os.path.join(out, "quantized_post_train_model.pth")
        spec = build_model("vit_b_16")
        _p, _s, masks, observers = load_lost_checkpoint(qpth, spec)
        assert masks and len(observers) == 52, len(observers)
        print(f"quantize --mode ptq vit_b_16 (phase 12's iteration-01 checkpoint): "
              f"{secs:.1f} s; {len(observers)} observers in {os.path.basename(qpth)} "
              f"({os.path.getsize(qpth) / 1e6:.0f} MB); launches {got} ({card})")
        voc = os.path.join(root, "VOC2007")
        items = voc_tree(voc, 2 * BATCH, seed=3)
        lost_out = os.path.join(root, "lost")
        lines, secs, got = quantize_cli(cli, [
            "lost", "--model", "vit_b_16", "--patch-size", "16", "--dtype", "int8",
            "--data-path", voc, "--checkpoint", qpth, "--batch-size", str(BATCH),
            "--workers", "8", "--output-dir", lost_out], counters)
        run = dict(ldrv.LAST_RUN)
        want = 12 * run["batches"]
        assert got["flash bf16"] == got["every"] == want and got["fused MLP"] == 0, (got, want)
        with open(os.path.join(lost_out, "preds.pkl"), "rb") as f:
            preds = pickle.load(f)
        assert len(preds) == len(items) - len(run["failed"]) > 0
        print(f"lost --dtype int8 vit_b_16 from the PTQ .pth (static qparams): {len(preds)} "
              f"boxes, {run['batches']} batches, launches {got}, "
              f"{run['images'] / run['decode_to_preds_seconds']:.1f} img/s e2e ({card})")
        lost_flash = got["flash bf16"]
        if keep_ptq:
            shutil.copy(qpth, keep_ptq)
        # 2. PTQ and one QAT epoch on the quantized_ CNNs
        for model in ("quantized_mobilenet_v2", "quantized_resnet50"):
            mspec = build_model(model)
            params, mmasks = seeded_pruned(mspec)
            ck = os.path.join(root, f"{model}.pth")
            sd = family(mspec).export_pth(params, None, mmasks, False)
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, ck)
            for mode in ("ptq", "qat"):
                out = os.path.join(root, f"{model}_{mode}")
                extra = (["--epochs", "1", "--lr", "0.001", "--print-freq", "4"]
                         if mode == "qat" else [])
                lines, secs, got = quantize_cli(cli, ["quantize", "--model", model, "--mode", mode,
                                                      "--resume", ck, "--output-dir", out,
                                                      *common, *extra], counters)
                assert got["every"] == 0, got
                name = "quantized_post_train_model.pth" if mode == "ptq" else "qat_checkpoint.pth"
                _p, stats, _m, obs = load_lost_checkpoint(os.path.join(out, name), mspec)
                assert stats is not None and obs and all(
                    np.isfinite(float(o["min"])) and np.isfinite(float(o["max"]))
                    for o in obs.values())
                if mode == "qat":
                    losses = [float(ln.rsplit(" ", 1)[1]) for ln in lines
                              if ln.startswith("QAT epoch 0 [")]
                    assert losses and all(np.isfinite(losses)), lines
                    assert sum(ln.startswith(("Test:QAT", "Test:INT8")) for ln in lines) == 2
                else:
                    assert any(ln.startswith("PTQ int8: acc1 ") for ln in lines)
                    if keep_mb_ptq and model == "quantized_mobilenet_v2":
                        shutil.copy(os.path.join(out, name), keep_mb_ptq)
                n = N_TRAIN_IMAGES if mode == "qat" else int(QUANT_BATCHES) * BATCH
                print(f"quantize --mode {mode} {model} 224 B={BATCH}: {secs:.1f} s ({n} train "
                      f"and {2 * N_VAL_IMAGES} val images with the set-up), {len(obs)} "
                      f"observers, launches {got} ({card})")
        return lost_flash
    finally:
        remove_later(root)


def quantize_phase(card, counters, gen, lost_core, vit_b_pth, keep_ptq=None, keep_mb_ptq=None):
    """Phase 18: int8 quantization (``int8_accumulators``, ``int8_lost``,
    ``quantize_runs``) and row 1 against its plain version at the int8 LOST
    shapes (ViT-S/16 and ViT-B/16, B=128, T = 896 with 769 tokens). Returns
    (kernel rows, {row name: launches})."""
    from vipers_torch.ops import flash_attention as fa

    t_phase = time.time()
    int8_accumulators(card)
    rows = [check_flash_at(fa, torch.bfloat16, gen, (BATCH, 6, 896, 64), (32, 24), (29, 22),
                           "int8"),
            check_flash_at(fa, torch.bfloat16, gen, (BATCH, 12, 896, 64), (32, 24), (29, 22),
                           "int8, H=12")]
    torch.cuda.empty_cache()
    launches = {rows[0]["name"]: int8_lost(card, counters, lost_core)}
    torch.cuda.empty_cache()
    launches[rows[1]["name"]] = quantize_runs(card, counters, vit_b_pth, keep_ptq, keep_mb_ptq)
    print(f"phase 18 int8 quantization: {time.time() - t_phase:.1f} s")
    return rows, launches


EXPORT_HW = (384, 512)  # the landscape VOC bucket: 24 x 32 patches, T = 769 -> 896
EXPORT_SEED = 19  # the images of the exported programs' batches

# run in a fresh process: imports torch and vipers_torch.ops (which registers
# the custom ops) and nothing else of the port, then loads each artifact named
# on the command line and runs one batch, counting the kernels' launches (set
# to 0 before each) and the program's torch._int_mm calls; the outputs go to
# <artifact>/replay.pt
EXPORT_REPLAY = r"""
import json, sys, torch
import vipers_torch.ops
from vipers_torch.ops import flash_attention as fa, fused_mlp as fm
seed, counts = int(sys.argv[1]), []
for art in sys.argv[2:]:
    with open(art + "/meta.json") as f:
        b, h, w, _ = json.load(f)["input_shape"]
    program = torch.export.load(art + "/model.pt2")
    int_mm = sum(n.target == torch.ops.aten._int_mm.default for n in program.graph.nodes)
    module = program.module()
    x = torch.randn((b, h, w, 3), generator=torch.Generator().manual_seed(seed)).cuda()
    for c in (fa.LAUNCHES, fm.LAUNCHES):
        c.update(dict.fromkeys(c, 0))
    with torch.no_grad():
        boxes, seeds, bg = module(x)
    torch.cuda.synchronize()
    torch.save({"boxes": boxes.cpu(), "seed": seeds.cpu(), "bg": bg.cpu()}, art + "/replay.pt")
    counts.append({"flash": dict(fa.LAUNCHES), "fused": dict(fm.LAUNCHES), "int_mm": int_mm})
    del program, module
print(json.dumps({"counts": counts,
                  "modules": sorted(m for m in sys.modules if m.startswith("vipers"))}))
"""


def export_images(n, hw):
    """The exported batches' images: seeded normal noise (already normalized,
    the serving contract), the same in the replaying process."""
    return torch.randn((n, *hw, 3), generator=torch.Generator().manual_seed(EXPORT_SEED))


def start_replay(arts):
    """Start one new process that imports only torch and vipers_torch.ops
    and runs each artifact of ``arts``; ``finish_replay`` collects it."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-c", EXPORT_REPLAY, str(EXPORT_SEED), *arts],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), arts


def finish_replay(replay):
    """[({"flash", "fused", "int_mm"}, outputs)] of ``start_replay``'s
    process, each artifact's, after checking it imported nothing of the
    port but vipers_torch.ops."""
    proc, arts = replay
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    allowed = {"vipers_torch", "vipers_torch.ops", "vipers_torch.ops._build",
               "vipers_torch.ops.flash_attention", "vipers_torch.ops.fused_mlp",
               "vipers_torch.ops.tokens"}
    assert set(got["modules"]) <= allowed, got["modules"]
    return [(c, torch.load(os.path.join(a, "replay.pt"))) for c, a in zip(got["counts"], arts)]


def equal_up_to_ties(tag, got, box_feat, seed, bg, scores, patch, hw):
    """The replayed (boxes xyxy, seed, bg) against the eager pipeline's
    (box_feat, seed, bg): equal, or a seed tied at the top score (phase
    12's rule) where they differ. Returns the images whose seeds agree."""
    ymin, ymax, xmin, xmax = (box_feat[:, i].float() for i in range(4))
    boxes = torch.stack([patch[1] * xmin, patch[0] * ymin,
                         torch.clamp(patch[1] * xmax, max=float(hw[1])),
                         torch.clamp(patch[0] * ymax, max=float(hw[0]))], dim=-1)
    same = got["seed"] == seed.to(torch.int32)
    assert scores is not None or bool(same.all()), tag
    assert torch.equal(got["boxes"][same], boxes[same]), tag
    assert torch.equal(got["bg"][same], bg[same]), tag
    for i in torch.nonzero(~same).flatten().tolist():
        s = scores[i]
        assert s[got["seed"][i]] == s[seed[i]] == s.max(), (tag, i)
    return int(same.sum())


def export_vit_lost(counters, pth, dtype, root, loaded):
    """``export --model vit_b_16 --pipeline lost`` of ``pth`` at 384x512,
    B=128 (``--verify`` in bf16 and f32), and the eager pipeline on the
    artifact's 128 images (``loaded``: the checkpoints read so far, by
    path): (artifact dir, CLI seconds, the eager batch's launches and
    torch._int_mm calls, its (box_feat, seed, bg, scores) on the host)."""
    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import infer_num_classes
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import lost_core
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.train import quantize as tq

    art = os.path.join(root, f"vit_b_16_lost_{dtype}")
    verify = dtype != "int8"
    lines, secs, cli_got = quantize_cli(cli, [
        "export", "--model", "vit_b_16", "--checkpoint", pth, "--pipeline", "lost",
        "--dtype", dtype, "--batch-size", str(BATCH), "--image-size", *map(str, EXPORT_HW),
        "--output-dir", art, *(["--verify"] if verify else [])], counters)
    assert not verify or any(ln.startswith("verify: artifact output matches") for ln in lines)
    # --verify ran the artifact and the direct forward once each (every: row
    # 1, row 4 and row 4 again by width); the export alone launches nothing
    assert cli_got["every"] == verify * 2 * 12 * (3 if dtype == "bf16" else 1), cli_got
    if pth not in loaded:
        loaded[pth] = load_lost_checkpoint(pth, build_model("vit_b_16"))
    params, _stats, masks, observers = loaded[pth]
    spec = build_model("vit_b_16", num_classes=infer_num_classes(params) or 0)
    ex = LostFeatureExtractor(spec, params, masks, observers=observers, compute_dtype={
        "bf16": torch.bfloat16, "f32": None, "int8": "int8"}[dtype])
    inp = ex.prepare_batch(list(export_images(BATCH, EXPORT_HW).numpy()), PATCH)
    assert inp[2] is None  # exact fit: no token mask, as in the artifact
    torch.cuda.synchronize()
    reset_counts(*counters)
    calls0 = tq.INT_MM_CALLS[0]
    out = [z.cpu() for z in ex.make_batched_pipeline(K_PATCHES)(*inp)]
    torch.cuda.synchronize()
    eager = {"flash": dict(fa.LAUNCHES), "fused": dict(fm.LAUNCHES),
             "int_mm": tq.INT_MM_CALLS[0] - calls0}
    feats = ex.batched_features(*inp)
    out.append(lost_core(feats, inp[3], (EXPORT_HW[0] // PATCH, EXPORT_HW[1] // PATCH),
                         K_PATCHES)["scores"].cpu())
    return art, secs, eager, out


def export_vit_lost_checks(card, counters, vit_b_pth, ptq_pth, root, meanwhile):
    """``export_vit_lost`` in bf16 and f32 from ``vit_b_pth`` and in int8
    from ``ptq_pth``, then the three artifacts in one fresh process
    (``start_replay``; ``meanwhile()`` runs in this process until it ends):
    launches a batch there and in the eager batch (row 1 bf16 or f32 12,
    row 4 12 in bf16 and 0 in f32 and int8; int8: as many torch._int_mm
    calls, 26), boxes, seeds and background flags equal to the eager
    pipeline's (up to top-score ties). Returns {dtype: the replay's
    counts}."""
    runs, loaded = {}, {}
    for dtype, pth in (("bf16", vit_b_pth), ("f32", vit_b_pth), ("int8", ptq_pth)):
        runs[dtype] = export_vit_lost(counters, pth, dtype, root, loaded)
        torch.cuda.empty_cache()
    del loaded
    t0 = time.perf_counter()
    replay = start_replay([runs[d][0] for d in runs])
    try:
        meanwhile()
        replays = finish_replay(replay)
    finally:  # a failure here leaves no process behind
        if replay[0].poll() is None:
            replay[0].kill()
            replay[0].communicate()
    replay_s = time.perf_counter() - t0
    layers = 12
    got_all = {}
    for (dtype, (art, secs, eager, (box, seed, bg, scores))), (got, outs) in zip(runs.items(),
                                                                               replays):
        key = "float32" if dtype == "f32" else "bfloat16"
        for counts in (got, eager):
            assert counts["flash"][key] == layers == sum(counts["flash"].values()), counts
            assert counts["fused"]["bfloat16"] == (layers if dtype == "bf16" else 0), counts
        assert got["int_mm"] == eager["int_mm"] == (2 * layers + 2 if dtype == "int8" else 0), (
            got["int_mm"], eager["int_mm"])
        agree = equal_up_to_ties(f"vit_b_16 {dtype}", outs, box, seed, bg, scores,
                                 (PATCH, PATCH), EXPORT_HW)
        mb = os.path.getsize(os.path.join(art, "model.pt2")) / 1e6
        counts = {"flash": got["flash"][key], "fused MLP": got["fused"]["bfloat16"],
                  "int_mm": got["int_mm"]}
        how = "export + verify" if dtype != "int8" else "export"
        print(f"export vit_b_16 lost {dtype} 384x512 B={BATCH}: {how} {secs:.1f} s, "
              f"{mb:.0f} MB; launches a batch in the fresh process {counts} (eager the same); "
              f"seeds equal {agree}/{BATCH}, boxes and flags equal where they are, ties "
              f"elsewhere; seed in the background {int(bg.sum())}/{BATCH} ({card})")
        got_all[dtype] = got
    print(f"fresh process (torch and vipers_torch.ops only): the three artifacts loaded and "
          f"run in {replay_s:.1f} s, the ResNet-50 and classify exports beside it")
    return got_all


def export_cnn_and_classify(card, counters, vit_b_pth, root):
    """``export --model resnet50 --pipeline lost`` (seed-0 weights, the
    canonical bucket of its 224 input, B=128, bf16, ``--verify``): no port
    kernel launches, boxes, seeds and flags equal to the eager CNN
    pipeline's; ``export --model vit_b_16`` classify of phase 12's
    checkpoint at 224, B=128, bf16, ``--verify`` (row 4 12 a forward)."""
    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.export import load_artifact
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor

    art = os.path.join(root, "resnet50_lost")
    lines, secs, got = quantize_cli(cli, ["export", "--model", "resnet50", "--pipeline", "lost",
                                          "--batch-size", str(BATCH), "--output-dir", art,
                                          "--verify"], counters)
    assert got["every"] == 0, got
    assert any(ln.startswith("verify: artifact output matches") for ln in lines), lines
    fn, meta = load_artifact(art)
    hw = tuple(meta["input_shape"][1:3])
    spec = build_model("resnet50")
    ex = LostFeatureExtractor(spec, spec.init(torch.Generator().manual_seed(0)),
                              compute_dtype=torch.bfloat16)
    assert ex.cnn_bucket_key(*hw) == hw
    x = export_images(BATCH, hw)
    inp = ex.prepare_cnn_batch(list(x.numpy()), hw)
    reset_counts(*counters)
    box, seed, bg = (z.cpu() for z in ex.make_batched_cnn_pipeline(K_PATCHES)(*inp))
    boxes, seeds, bgs = (z.cpu() for z in fn(x))
    assert all_launches(counters) == 0
    sy, sx = ex.cnn_scales(*hw)
    agree = equal_up_to_ties("resnet50", {"boxes": boxes, "seed": seeds, "bg": bgs}, box, seed,
                             bg, None, (sy, sx), hw)
    assert agree == BATCH
    print(f"export resnet50 lost bf16 {hw[0]}x{hw[1]} (canonical bucket) B={BATCH}: export + "
          f"verify {secs:.1f} s; 0 kernel launches; boxes, seeds and flags equal to the eager "
          f"pipeline's on {BATCH}/{BATCH} ({card})")
    art = os.path.join(root, "vit_b_16_classify")
    lines, secs, got = quantize_cli(cli, ["export", "--model", "vit_b_16", "--checkpoint",
                                          vit_b_pth, "--dtype", "bf16", "--batch-size",
                                          str(BATCH), "--output-dir", art, "--verify"], counters)
    # 12 a forward, the artifact's and the direct one (every: by width too)
    assert got["fused MLP"] == 24 and got["every"] == 48, got
    assert any(ln.startswith("verify: artifact output matches") for ln in lines), lines
    print(f"export vit_b_16 classify bf16 224 B={BATCH}: export + verify {secs:.1f} s; "
          f"launches {got} (the artifact's forward and the direct one) ({card})")


BENCH_EXPORT_LAYERS = 6


def export_phase(card, counters, gen, vit_b_pth, ptq_pth):
    """Phase 19: serving export (``export_vit_lost`` bf16, f32 and int8,
    ``export_cnn_and_classify``, ``vipers_torch.tools.bench_export``) and
    row 1 against its plain version at the exported ViT-B/16 LOST shape
    (B*H = 128*12, T = 896 with 769 tokens, no bucket pad), f32 and bf16.
    Returns (kernel rows, {row name: launches}, {row name: the exported
    bf16 program's launches a batch} for rows of earlier phases)."""
    import tempfile

    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.tools import bench_export

    t_phase = time.time()
    rows = [check_flash_at(fa, dt, gen, (BATCH, 12, 896, 64), (24, 32), (24, 32), "export, H=12")
            for dt in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vipers_torch_export_")
    try:
        got = export_vit_lost_checks(
            card, counters, vit_b_pth, ptq_pth, root,
            lambda: export_cnn_and_classify(card, counters, vit_b_pth, root))
    finally:
        remove_later(root)
    torch.cuda.empty_cache()
    t0 = time.time()
    # the ViT-S/16 programs cut to 6 blocks (phase 21 took the time): artifact
    # against eager is a ratio of one program's two runs, at any depth
    rates = bench_export.run(reps=2, layers=BENCH_EXPORT_LAYERS)
    host = {k: round(v, 2) for k, v in bench_export.op_host_cost().items()}
    print(f"bench_export (ViT-S/16 at {BENCH_EXPORT_LAYERS} blocks) {json.dumps(rates)}; host "
          f"us a call {json.dumps(host)}; {time.time() - t0:.1f} s ({card})")
    print(f"phase 19 serving export: {time.time() - t_phase:.1f} s")
    return rows, {rows[0]["name"]: got["f32"]["flash"]["float32"],
                  rows[1]["name"]: got["bf16"]["flash"]["bfloat16"]}, {
        "fused_ln_fc1_gelu[bf16, D=768]": got["bf16"]["fused"]["bfloat16"]}


# Phase 20: mobilenet_v2 on lost and explain, DINO explain, lost
# --visualize, train --profile-dir and --debug-nans.
N_MB_JPEG = BATCH  # fixture symlinks the mobilenet lost runs read: one batch
N_MB_EXACT = 32  # of them, the --exact-shapes run's (one image a forward)
MB_CPU_BATCH = 4  # mobilenet's card-vs-CPU LOST batch, full depth
N_VIZ = 8  # JPEGs of the --visualize runs
DINO_EXPLAIN_CPU_LAYERS = 2  # the card-vs-CPU cut of dino_vit_small's heatmaps
PROFILE_TRAIN, PROFILE_VAL = 256, 128  # the train --profile-dir run's ImageFolder


def counted_cli(cli, argv, counters):
    """(seconds, launches {row: n}, every launch) of one CLI run, the
    counts set to 0 just before it and read just after."""
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    assert cli(argv) == 0, argv
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {"flash f32": fa.LAUNCHES["float32"], "flash bf16": fa.LAUNCHES["bfloat16"],
           "flash bwd f32": fa.BWD_LAUNCHES["float32"], "fused MLP": fm.LAUNCHES["bfloat16"]}
    return dt, got, all_launches(counters)


def read_preds(out):
    import pickle

    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        return {k: np.asarray(v).tolist() for k, v in pickle.load(f).items()}


def int8_forward_accumulators(card, spec, params, stats, masks, observers, imgs_hw):
    """Every int32 accumulator of one int8 mobilenet forward on the card (B
    = 2 at the 512x384 bucket, static qparams from the PTQ checkpoint's
    observers), recomputed on the CPU by the plain versions from the same
    int8 operands: all equal."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.train import quantize as tq

    ex = LostFeatureExtractor(spec, params, masks, compute_dtype="int8", batch_stats=stats,
                              observers=observers)
    key = ex.cnn_bucket_key(*imgs_hw[0])
    imgs = make_images(np.random.default_rng(20), imgs_hw)
    inp = ex.prepare_cnn_batch(imgs, key, exact_hw=imgs_hw)
    calls = []
    orig = {"matmul_int32": tq.matmul_int32, "conv_int32": tq.conv_int32}

    def recorder(name):
        def fn(*args):
            out = orig[name](*args)
            if args[0].is_cuda:
                calls.append((name, [a.cpu() if torch.is_tensor(a) else a for a in args],
                              out.cpu()))
            return out
        return fn

    try:
        for name in orig:
            setattr(tq, name, recorder(name))
        ex.cnn_features(*inp)
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(tq, name, fn)
    assert calls
    for name, args, out in calls:
        want = orig[name](*args)
        assert want.dtype == out.dtype == torch.int32 and torch.equal(out, want), name
    kinds = {n: sum(c[0] == n for c in calls) for n in orig}
    print(f"int8 mobilenet accumulators: every int32 accumulator of a B=2 forward at bucket "
          f"{key} ({kinds} calls on the card) equal to the CPU's plain versions ({card})")


def mobilenet_lost(card, counters, lost_core, root, voc, voc_exact, mb_ptq):
    """20.1-20.2: returns the seed-0 .pth of the masked mobilenet_v2."""
    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_mobilenet_v2, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery import driver as ldrv
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.pruning import init_masks, magnitude_prune

    spec = build_model("mobilenet_v2")
    params, masks = seeded_pruned(spec)
    pth = os.path.join(root, "mobilenet_v2.pth")
    save_torch_state_dict(export_mobilenet_v2(params, None, masks, bake_masks=False), pth)
    common = ["--arch", "mobilenet", "--model", "mobilenet_v2", "--checkpoint", pth,
              "--batch-size", str(BATCH), "--workers", "8"]
    preds = {}
    for tag, data, extra in (("bf16", voc, ["--dtype", "bf16"]), ("f32", voc, []),
                             ("exact-shapes", voc_exact, ["--exact-shapes"])):
        out = os.path.join(root, f"mb_{tag}")
        dt, got, every = counted_cli(cli, ["lost", *common, "--data-path", data,
                                           "--output-dir", out, *extra], counters)
        run = dict(ldrv.LAST_RUN)
        preds[tag] = read_preds(out)
        assert every == 0, got
        assert len(preds[tag]) == run["images"] - len(run["failed"]) > 0
        print(f"lost --arch mobilenet mobilenet_v2 [{tag}]: {run['images']} JPEGs, "
              f"{len(preds[tag])} boxes, {'per image' if run['per_image'] else 'batched'}, "
              f"{run['images'] / run['decode_to_preds_seconds']:.1f} img/s e2e ({dt:.1f} s), "
              f"0 attention or fused-MLP launches ({card})")
    same = sum(preds["exact-shapes"][k] == preds["f32"].get(k) for k in preds["exact-shapes"])
    print(f"mobilenet --exact-shapes boxes equal to the bucketed f32 run's on "
          f"{same}/{len(preds['exact-shapes'])} images (the reference's native shapes; the "
          f"first {N_MB_EXACT} of its JPEGs)")

    # the batched pipeline at the 512x384 canonical bucket, B=128 and B=1
    rng = np.random.default_rng(20)
    hw = [(H, W)] * BATCH
    imgs = make_images(rng, hw)
    for name, dt in (("bf16", torch.bfloat16), ("f32", None)):
        ex = LostFeatureExtractor(spec, params, masks, compute_dtype=dt)
        key = ex.cnn_bucket_key(H, W)
        inp = ex.prepare_cnn_batch(imgs, key, exact_hw=hw)
        one = ex.prepare_cnn_batch(imgs[:1], key, exact_hw=hw[:1])
        pipe = ex.make_batched_cnn_pipeline(K_PATCHES)
        reset_counts(*counters)
        ips, p50 = throughput(pipe, inp, one)
        torch.cuda.synchronize()
        assert all_launches(counters) == 0, counters
        print(f"mobilenet_v2 CNN LOST [{name}] bucket {key}: {ips:.1f} img/s at B={BATCH}; p50 "
              f"{p50:.2f} ms at B=1; 0 launches ({card})")
        if dt is None:
            # card against CPU at full depth, B=4 mixed sizes in one bucket
            sizes = [(H, W), (H - 20, W - 9), (H - 41, W - 30), (H - 13, W - 2)][:MB_CPU_BATCH]
            compare_cnn_with_cpu("mobilenet_v2 f32", spec, params, masks, ex,
                                 cnn_bucket_images(ex, sizes, rng), lost_core)
        del ex, inp

    # int8 from phase 18's PTQ checkpoint of quantized_mobilenet_v2
    qspec = build_model("quantized_mobilenet_v2")
    qparams, qstats, qmasks, observers = load_lost_checkpoint(mb_ptq, qspec)
    assert observers, "the PTQ checkpoint carries no observers"
    int8_forward_accumulators(card, qspec, qparams, qstats, qmasks, observers,
                              [(H, W), (H - 37, W - 11)])
    out = os.path.join(root, "mb_int8")
    dt, got, every = counted_cli(cli, ["lost", "--arch", "mobilenet", "--model",
                                       "quantized_mobilenet_v2", "--dtype", "int8",
                                       "--data-path", voc, "--checkpoint", mb_ptq,
                                       "--batch-size", str(BATCH), "--workers", "8",
                                       "--output-dir", out], counters)
    run = dict(ldrv.LAST_RUN)
    assert every == 0 and len(read_preds(out)) == run["images"] - len(run["failed"]) > 0
    print(f"lost --dtype int8 quantized_mobilenet_v2 from phase 18's PTQ .pth: "
          f"{run['images'] / run['decode_to_preds_seconds']:.1f} img/s e2e, 0 launches ({card})")
    return pth


def dino_mobilenet_explain(card, counters, fa, gen, root, mb_pth):
    """20.3: returns (the two DINO explain rows, their launches)."""
    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.registry import build_model
    from vipers_torch.core.checkpoint import family
    from vipers_torch.explain import driver as xd

    rows = check_flash_explain(fa, gen, heads=6, tag="explain, dino")
    voc = os.path.join(root, "explain_voc")
    all_sizes = explain_voc(voc)
    n = EXPLAIN_EVAL_IMAGES
    launches = {}
    for model, extra in (("mobilenet_v2", ["--checkpoint", mb_pth]), ("dino_vit_small", [])):
        out = os.path.join(root, f"ee_{model}")
        xd.LAST_RUN.clear()
        dt, got, every = counted_cli(cli, ["explain-eval", "--model", model, *extra,
                                           "--voc-root", voc, "--num-images", str(n),
                                           "--output-dir", out], counters)
        methods = ("gradCAM", "ig") + (("attention",) if model.startswith("dino") else ())
        for m in methods:
            lines = open(os.path.join(out, f"{m}_{model}_pruning_iteration_00.txt")).read()
            vals = [float(ln.split(":")[-1]) for ln in lines.splitlines()[:2]]
            assert lines.splitlines()[2] == f"On a total of {n} images."
            assert all(0.0 <= v <= 1.0 for v in vals), (model, m, vals)
        if model.startswith("dino"):
            blocks = build_model(model).cfg.depth - 1  # the last block returns its attention
            want = {"flash f32": n * blocks * (1 + 1 + 2 * 50),
                    "flash bwd f32": n * blocks * 2 * 50}
            assert {k: got[k] for k in want} == want and every == sum(want.values()), (got, want)
            launches = {"flash_attention_fwd[f32, explain, dino]": got["flash f32"],
                        "flash_attention_bwd[f32, explain, dino]": got["flash bwd f32"]}
        else:
            assert every == 0, got
        per = {k: 1e3 * v / n for k, v in xd.LAST_RUN["method_s"].items()}
        print(f"explain-eval {model} f32: {n} images, {n / dt:.3f} img/s e2e ({dt:.1f} s; ms "
              f"an image: {', '.join(f'{k} {v:.1f}' for k, v in per.items())}); launches "
              f"{got} ({card})")
    # card against CPU on the flattest image: mobilenet at full depth, DINO cut
    stem = min(all_sizes, key=lambda s_: all_sizes[s_][1])
    spec, card_model = xd._load_model("mobilenet_v2", mb_pth)
    _s, cpu_model = xd._load_model("mobilenet_v2", mb_pth, device="cpu")
    explain_card_vs_cpu(spec, card_model, cpu_model, voc, stem, "mobilenet_v2")
    spec, params = cut_dino(build_model("dino_vit_small"),
                            build_model("dino_vit_small").init(torch.Generator().manual_seed(0)),
                            DINO_EXPLAIN_CPU_LAYERS)
    models = []
    for dev in ("cuda", "cpu"):
        m = spec.module()
        m.load_state_dict({**dict(m.named_buffers()),
                           **family(spec).state_dict(params, None, None)})
        models.append(m.eval().requires_grad_(False).to(dev))
    explain_card_vs_cpu(spec, *models, voc, stem,
                        f"dino_vit_small, {DINO_EXPLAIN_CPU_LAYERS} blocks")
    return rows, launches


def visualize_runs(card, counters, gen, fa, fm, root, voc_viz, mb_pth):
    """20.4: returns (the B = 1 rows 1 and 4, their launches)."""
    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    # one image on its 512x384 bucket: 769 tokens sequence-padded to 896, no bucket pad
    rows = [check_flash_at(fa, torch.bfloat16, gen, (1, 6, 896, 64), (32, 24), (32, 24),
                           tag="B=1", pad_rows=slice(0, 1)),
            check_fused_mlp(fm, gen, m=896, tag="M=896")]
    spec = build_model("vit_s_16")
    params, masks = seeded_pruned(spec)
    vit_pth = os.path.join(root, "vit_s_16.pth")
    save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), vit_pth)
    launches = {}
    for model, arch, pth, dtype in (("vit_s_16", "vit", vit_pth, "bf16"),
                                    ("mobilenet_v2", "mobilenet", mb_pth, "f32")):
        common = ["lost", "--arch", arch, "--model", model, "--checkpoint", pth,
                  "--data-path", voc_viz, "--dtype", dtype, "--batch-size", str(N_VIZ),
                  "--workers", "8"]
        out = os.path.join(root, f"viz_{model}_batched")
        _dt, got, _every = counted_cli(cli, [*common, "--output-dir", out], counters)
        batched = read_preds(out)
        for kind in ("pred", "seed_expansion"):
            out = os.path.join(root, f"viz_{model}_{kind}")
            dt, got, every = counted_cli(cli, [*common, "--visualize", kind, "--output-dir", out],
                                         counters)
            drawn = read_preds(out)
            pngs = [f for f in os.listdir(out) if f.endswith(f"_{kind}.png")]
            assert len(pngs) == len(drawn) == len(batched) > 0, (len(pngs), len(drawn))
            assert drawn == batched, [k for k in drawn if drawn[k] != batched.get(k)]
            if arch == "vit":
                want = 12 * N_VIZ
                # every: the flash and fused-MLP counts, and the fused MLP's by width
                assert got["flash bf16"] == got["fused MLP"] == want and every == 3 * want, got
                launches = {"flash_attention_fwd[bf16, B=1]": got["flash bf16"],
                            "fused_ln_fc1_gelu[bf16, M=896]": got["fused MLP"]}
            else:
                assert every == 0, got
            print(f"lost --visualize {kind} {model} {dtype}: {len(pngs)} drawings, boxes equal "
                  f"to the batched run's on {len(drawn)}/{len(batched)}, {dt:.1f} s "
                  f"({N_VIZ / dt:.1f} img/s), launches {got} ({card})")
    return rows, launches


def profile_and_nan_runs(card, counters, root):
    """20.5-20.6."""
    import dataclasses
    import json

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core import profiling
    from vipers_torch.core import registry as treg
    from vipers_torch.ops import attention_train as at

    data = os.path.join(root, "profile_if")
    imagefolder_tree(data, PROFILE_TRAIN, PROFILE_VAL, seed=20)
    common = ["--data-path", data, "--num-classes", "1000", "--batch-size", str(BATCH),
              "--epochs", "1", "--amp", "--workers", "8", "--print-freq", "1"]
    trace_dir = os.path.join(root, "trace")
    dt, _got, every = counted_cli(cli, ["train", "--model", "vit_s_16", *common,
                                        "--pruning-method", "snip", "--target-sparsity", "0.5",
                                        "--profile-dir", trace_dir,
                                        "--output-dir", os.path.join(root, "prof_out")],
                                  counters)
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1, traces
    path = os.path.join(trace_dir, traces[0])
    with open(path) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    fwd = [n for n in names if "attention_train_fwd_kernel" in n]
    bwd = [n for n in names if "attention_bwd_kernel" in n]
    assert fwd and bwd and at.LAUNCHES["fwd"] > 0 and at.LAUNCHES["bwd"] > 0, (
        sorted(names)[:20], at.LAUNCHES)
    print(f"train --profile-dir vit_s_16 --amp 224 B={BATCH}, 1 epoch: {dt:.1f} s; one Chrome "
          f"trace ({os.path.getsize(path) / 1e6:.1f} MB) names the training attention kernels "
          f"({fwd[0][:60]}..., {bwd[0][:60]}...); launches fwd {at.LAUNCHES['fwd']}, bwd "
          f"{at.LAUNCHES['bwd']} ({card})")

    # --debug-nans: vit_s_16 with one NaN in the first block's fc1
    def nan_build(**kw):
        spec = treg.build_model("vit_s_16", **kw)

        def init(g):
            params = spec.init(g)
            params["encoder_layer_0"]["mlp"]["fc1"]["kernel"][0, 0] = float("nan")
            return params

        return dataclasses.replace(spec, init=init)

    treg._BUILTIN_MODELS["vit_s_16_nan"] = nan_build
    try:
        t0 = time.perf_counter()
        try:
            cli(["train", "--model", "vit_s_16_nan", *common, "--pruning-method", "magnitude",
                 "--pruning-rate", "0.5", "--pruning-threshold", "40", "--debug-nans",
                 "--output-dir", os.path.join(root, "nan_out")])
        except FloatingPointError as e:
            print(f"train --debug-nans vit_s_16 with one NaN weight: FloatingPointError on the "
                  f"card after {time.perf_counter() - t0:.1f} s ({str(e)[:80]}) ({card})")
        else:
            raise AssertionError("train --debug-nans ran through a NaN weight")
    finally:
        del treg._BUILTIN_MODELS["vit_s_16_nan"]
    assert profiling._NAN_HOOK is None and not torch.is_anomaly_enabled()


def debug_surface_phase(card, counters, gen, lost_core, mb_ptq):
    """Phase 20 (see the module docstring). Returns (its kernel rows, their
    launches)."""
    import tempfile

    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="vipers_torch_debug_surface_")
    try:
        voc = os.path.join(root, "VOC2007")
        voc_tree(voc, N_MB_JPEG, seed=20)
        voc_exact = os.path.join(root, "VOC_exact")
        voc_tree(voc_exact, N_MB_EXACT, seed=20)  # the same draw: the first N_MB_EXACT
        voc_viz = os.path.join(root, "VOC_viz")
        voc_tree(voc_viz, N_VIZ, seed=21)
        mb_pth = mobilenet_lost(card, counters, lost_core, root, voc, voc_exact, mb_ptq)
        rows, launches = dino_mobilenet_explain(card, counters, fa, gen, root, mb_pth)
        viz_rows, viz_launches = visualize_runs(card, counters, gen, fa, fm, root, voc_viz,
                                                mb_pth)
        profile_and_nan_runs(card, counters, root)
    finally:
        remove_later(root)
    print(f"phase 20 mobilenet, DINO explain, the debugging surface: "
          f"{time.time() - t_phase:.1f} s")
    return rows + viz_rows, {**launches, **viz_launches}


# phase 21: data parallelism. A child process runs the port's CLIs as one
# rank of a torchrun-style launch and writes what it saw as JSON.
DDP_CHILD = "import sys, chip_smoke; chip_smoke.ddp_child(*sys.argv[1:])"


def sp_features(pth, voc, out, multi):
    """The ViT-S/16 LOST features (f32, ``extract`` on each JPEG of ``voc``,
    host-normalized) of the checkpoint ``pth``, under sequence parallelism
    over every rank when ``multi``; saved to ``out`` (rank 0)."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.detection import load_image_normalized
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.parallel import mesh

    spec = build_model("vit_s_16")
    params, _, masks, _ = load_lost_checkpoint(pth, spec)
    ex = LostFeatureExtractor(spec, params, masks, sequence_parallel=multi)
    feats = []
    jpegs = os.path.join(voc, "JPEGImages")
    for name in sorted(os.listdir(jpegs)):
        img = load_image_normalized(os.path.join(jpegs, name))
        h, w = img.shape[:2]
        padded = np.zeros((-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, 3), np.float32)
        padded[:h, :w] = img
        feats.append(ex.extract(padded, PATCH)[0].cpu())
    if mesh.is_main():
        torch.save(feats, out)
    return 0


def run_ddp_stages(stages):
    """Each (name, argv) of ``stages`` through the port's CLI in this
    process (``sp_features`` for an argv starting with it), the launch
    counts set to 0 just before and read just after: {name: {rc, s,
    to_data_s, rows_7_8, row_1, row_4, row_1_any, row_4_d768, row_4_any,
    other, lines[, batches]}} (``to_data_s``: a train stage's seconds to its
    first decoded batch; ``row_1_any``, ``row_4_any``: every dtype and
    width)."""
    import contextlib
    import io

    from vipers_torch.cli.main import main as cli
    from vipers_torch.discovery import driver as lost_driver
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.train import driver as tdrv

    counters = (at.LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES, fa.PACKED_LAUNCHES, fm.LAUNCHES,
                fm.WIDTH_LAUNCHES)
    res = {}
    for stage, argv in stages:
        torch.cuda.synchronize()
        reset_counts(*counters)
        buf = io.StringIO()
        t0 = time.perf_counter()
        t0_wall = time.time()
        with contextlib.redirect_stdout(buf):
            rc = sp_features(*argv[1:]) if argv[0] == "sp_features" else cli(argv)
        torch.cuda.synchronize()
        res[stage] = {
            "rc": rc, "s": time.perf_counter() - t0,
            "to_data_s": (tdrv.LAST_RUN.get("t_first_decode", t0_wall) - t0_wall
                          if argv[0] == "train" else None),
            "rows_7_8": [at.LAUNCHES[at._launch_key(d, "f32", 64)] for d in ("fwd", "bwd")],
            "row_1": fa.LAUNCHES["bfloat16"], "row_4": fm.LAUNCHES["bfloat16"],
            "row_1_any": sum(fa.LAUNCHES.values()), "row_4_any": sum(fm.LAUNCHES.values()),
            "row_4_d768": fm.WIDTH_LAUNCHES.get(768, 0),
            "other": sum(fa.BWD_LAUNCHES.values()) + sum(fa.PACKED_LAUNCHES.values()),
            "lines": [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith(("Test:", "PTQ", "corloc", "Sparsity", "| distributed",
                                        "train mesh", "LOST sequence"))],
        }
        assert rc == 0, (stage, rc)
        if stage.startswith("lost"):
            res[stage]["batches"] = lost_driver.LAST_RUN["batches"]
    return res


def gloo_cuda_probe():
    """Which gloo collectives take CUDA tensors (the port hands them its
    CUDA tensors as it would NCCL), and the pipeline's send/recv (``pp.send``
    / ``pp.recv`` from rank 0 to rank 1, with the route they took): {name:
    "ok" or what raised, and its seconds}, on a group of its own with a
    short deadline. Every rank calls it."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=60))
    t = torch.ones(8, device="cuda")
    n = dist.get_world_size()
    probes = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(n)], t,
                                              group=group),
        "reduce_scatter": lambda: dist.reduce_scatter(torch.empty(8 // n, device="cuda"),
                                                      list(t.chunk(n)), group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(t), t,
                                                            group=group),
    }
    out = {}
    for name, fn in probes.items():
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports what raised
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        out[name] += f" ({time.perf_counter() - t0:.2f} s)"
    # the pipeline's activations and cotangents between neighbouring ranks:
    # gloo's TCP transport refuses CUDA memory (a direct send raised "writev
    # ... Bad address" or aborted the sender), so ``parallel.pp`` moves them
    # through pinned host memory under gloo: rank 0 sends, rank 1 checks
    from vipers_torch.parallel import pp

    t0 = time.perf_counter()
    try:
        if dist.get_rank() == 0:
            pp.send(3 * t, 1)
        elif dist.get_rank() == 1:
            assert torch.equal(pp.recv(t.shape, t.dtype, 0, t.device), 3 * t)
        out["send_recv"] = f"ok, route {pp.P2P_ROUTE}"
    except Exception as e:  # noqa: BLE001 - the probe reports what raised
        out["send_recv"] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    out["send_recv"] += f" ({time.perf_counter() - t0:.2f} s)"
    return out


def ddp_child(cfg_path, out_prefix, go):
    """One rank: the CUDA context and libraries, then, once the file ``go``
    exists, the stages of ``cfg_path`` (the CLI joins the process group on
    its first call) and the gloo probe; writes ``{out_prefix}_{rank}.json``."""
    from vipers_torch.cli.main import main as _cli  # noqa: F401 - imported before the wait
    from vipers_torch.parallel import mesh

    # the CUDA context, cuDNN and cuBLAS loaded before the wait
    x = torch.ones(2, 3, 16, 16, device="cuda", requires_grad=True)
    torch.nn.functional.conv2d(x, torch.ones(4, 3, 3, 3, device="cuda")).sum().backward()
    (x.detach().flatten(1) @ torch.ones(768, 4, device="cuda")).sum().item()
    t_ready = time.time()
    while not os.path.exists(go):
        time.sleep(0.05)
    t_go = time.time()
    from vipers_torch.parallel import pp

    with open(cfg_path) as f:
        res = run_ddp_stages(json.load(f)["stages"])
    res["rank"], res["world"] = mesh.rank(), mesh.world()
    res["p2p_route"] = dict(pp.P2P_ROUTE)
    res["gloo_cuda"] = gloo_cuda_probe()
    res["t_ready"], res["t_go"], res["t_exit"] = t_ready, t_go, time.time()
    with open(f"{out_prefix}_{mesh.rank()}.json", "w") as f:
        json.dump(res, f)


DDP_WORLD, DDP_BATCH = 2, 16  # ranks on the one card, per-rank batch (the process: 32)
DDP_TRAIN, DDP_VAL, DDP_JPEG = 64, 41, 64  # 2 global steps; a sentinel row on rank 1
# model parallelism on the 2 ranks: ViT-B/16 --amp, 2 steps and the epoch-end
# eval; 128 eval rows a forward (or pipelined microbatch) make 128 * 197 rows,
# which the fused MLP's block rule (rows % 128) takes, so row 4 runs at F / k
TP_BATCH, PP_BATCH, PP_MICROBATCH, MP_VAL, SP_JPEG = 128, 256, 128, 128, 8


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_resnet():
    """The phase's ResNet-50 (1000 classes): (spec, seed-0 params, their
    global magnitude masks at ``SPARSITY``)."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    spec = build_model("resnet50", num_classes=1000)
    return (spec, *seeded_pruned(spec))


def bn_biases_plus3(params):
    """``params`` with every BatchNorm bias raised by 3."""
    from vipers_torch.core.tree import flatten_dict, unflatten_dict

    return unflatten_dict({p: (v + 3.0 if p[-1] == "bias" and "bn" in p[-2] else v)
                           for p, v in flatten_dict(params).items()})


def nccl_one_rank(card, spec, params, masks):
    """A one-rank NCCL group on the card: the data-parallel ResNet-50 bf16
    step (224, B=32, full width, 1000 classes; its gradients all-reduced
    through NCCL) against the plain step from the same state and batch,
    3 steps each; parameters and running statistics must be equal. Returns
    (plain ms, data-parallel ms) a step, the first step untimed."""
    import torch.distributed as dist

    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.parallel import mesh
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.integers(0, 256, (32, 224, 224, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, 32)).cuda()
    x = make_device_normalize()(images)
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    ocfg = OptimConfig(lr=0.1, momentum=0.9, weight_decay=1e-4)
    states, ms = [], []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's atomics would differ run to run
    try:
        for dp in (False, True):
            if dp:
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                        world_size=1, rank=0)
                assert mesh.active() and mesh.world() == 1
            st = create_train_state(spec, params, masks, ocfg, 1)
            st, metrics = step(st, (x, labels))  # the first step sets cuDNN up: untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                st, metrics = step(st, (x, labels))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / 2)
            assert bool(torch.isfinite(metrics["loss"]))
            states.append({**{k: v.detach().clone() for k, v in st.params.items()},
                           **{k: v.clone() for k, v in st.batch_stats.items()}})
            del st
    finally:
        torch.backends.cudnn.deterministic = prev
        if dist.is_initialized():
            dist.destroy_process_group()
    diff = [k for k, v in states[0].items() if not torch.equal(v, states[1][k])]
    assert not diff, f"one-rank NCCL step differs from the plain step at {diff[:5]}"
    print(f"phase 21 one-rank NCCL: ResNet-50 bf16 step (224, B=32) after 3 steps equal to "
          f"the plain step ({len(states[0])} tensors); steps 2-3, host clock: the plain step "
          f"{ms[0]:.1f} ms, the one-rank NCCL data-parallel step {ms[1]:.1f} ms ({card})")
    return ms


def bn_order_witness(card, spec, params, masks):
    """What the BatchNorm reduction order alone does to 2 train steps: one
    process, ResNet-50 f32 (224, B=32, SGD lr 0.01 as the train stages,
    cuDNN deterministic), the moments as ``mean()`` against the
    data-parallel form (packed sums over the batch over the count,
    ``cnn._global_moments`` with no other rank), from the seed-0 start and
    from BatchNorm biases at +3. Printed beside the 2-rank comparison;
    nothing is held to a tolerance here."""
    import types

    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.models import cnn
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    rng = np.random.default_rng(23)
    norm = make_device_normalize()
    batches = [(norm(torch.from_numpy(rng.integers(0, 256, (32, 224, 224, 3),
                                                   dtype=np.uint8)).cuda()),
                torch.from_numpy(rng.integers(0, 1000, 32)).cuda()) for _ in range(2)]
    step = make_train_step(1000)
    ocfg = OptimConfig(lr=0.01)
    real = cnn.parallel
    packed = types.SimpleNamespace(data_world=lambda: 2, all_reduce_sum=lambda t: t)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for start, p0 in (("seed-0", params), ("BatchNorm biases +3", bn_biases_plus3(params))):
            runs = []
            for form in (real, packed):
                cnn.parallel = form
                st = create_train_state(spec, p0, masks, ocfg, 1)
                for b in batches:
                    st, metrics = step(st, b)
                assert bool(torch.isfinite(metrics["loss"]))
                runs.append({**{k: v.detach().double() for k, v in st.params.items()},
                             **{k: v.double() for k, v in st.batch_stats.items()}})
                del st
            cnn.parallel = real
            bad, rel = [], []
            for k, a in runs[0].items():
                d = (runs[1][k] - a).abs()
                excess = float((d - (3e-3 + 5e-2 * a.abs())).max())
                rel.append((float(d.norm() / max(float(a.norm()), 1e-30)), k))
                if excess > 0:
                    bad.append((excess, k))
            rel.sort(reverse=True)
            out[start] = (sorted(bad, reverse=True), rel[:3])
    finally:
        cnn.parallel = real
        torch.backends.cudnn.deterministic = prev
    for start, (bad, rel) in out.items():
        print(f"phase 21 witness, BatchNorm moments packed / count against mean(), one process "
              f"(ResNet-50 f32, 224, B=32, 2 steps) from {start}: worst relative L2 {rel}, "
              f"{len(bad)} tensors past rtol 5e-2 / atol 3e-3: {bad[:5]} ({card})")
    return out


def snip_global_batch_memory(card, resnet_spec, resnet_params):
    """What rank 0 holds when it takes SNIP's saliencies of the gathered
    global batch alone (``train.driver.global_snip_masks``): the driver's
    SNIP pass (f32, cuDNN deterministic, TF32 off) of ResNet-50 and
    ViT-B/16 at 224 on 128 and 256 images (8 ranks of 16 and of 32), its
    peak device memory above the weights and its seconds; the slope per
    image gives the largest gathered batch the card holds. Returns
    {model: (MiB an image, that largest batch)}."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.models import cnn
    from vipers_torch.pruning import init_masks, snip_saliency
    from vipers_torch.pruning.snip import snip_loss

    rng = np.random.default_rng(24)
    norm = make_device_normalize()
    total = torch.cuda.get_device_properties(0).total_memory
    vit = build_model("vit_b_16", num_classes=1000)
    out = {}
    for name, spec, params in (("resnet50", resnet_spec, resnet_params),
                               ("vit_b_16", vit, seeded_init(vit))):
        p = to_device(params, "cuda")
        loss = snip_loss(spec, 1000)
        base = init_masks(p, exclude=spec.prune_exclude)
        peaks = {}
        for n in (128, 256):
            images = torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8))
            labels = torch.from_numpy(rng.integers(0, 1000, n)).cuda()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with cnn.exact_f32_convs(), cnn.deterministic_convs():
                sal = snip_saliency(loss, p, (norm(images.cuda()), labels), masks=base)
            torch.cuda.synchronize()
            peaks[n] = (torch.cuda.max_memory_allocated() - held, time.perf_counter() - t0)
            assert all(bool(torch.isfinite(v).all()) for v in sal.values())
            del sal
        slope = (peaks[256][0] - peaks[128][0]) / 128
        fixed = peaks[256][0] - 256 * slope
        largest = int((total - torch.cuda.memory_allocated() - fixed) // slope)
        out[name] = (slope / 2**20, largest)
        print(f"phase 21 SNIP on a gathered global batch, {name} f32 224: peak above the "
              f"weights {peaks[128][0] / 2**30:.2f} GiB at 128 images ({peaks[128][1]:.2f} s), "
              f"{peaks[256][0] / 2**30:.2f} GiB at 256 ({peaks[256][1]:.2f} s); "
              f"{slope / 2**20:.1f} MiB an image, so rank 0's card ({total / 2**30:.1f} GiB) "
              f"holds a gathered batch of at most ~{largest} images ({card})")
        del p
    torch.cuda.empty_cache()
    return out


def ddp_inputs(root, params, masks):
    """The runs' inputs: phase 12's kind of ImageFolder, the seed-0
    ResNet-50 ``params`` with ``masks`` (50% global magnitude) as a .pth in
    a sweep directory for evaluate and quantize, the same ResNet-50 with
    every BatchNorm bias at +3 for train (ReLU inputs kept off the kink,
    where a rounding difference flips a gate: the CPU parity tests' start;
    ``bn_order_witness`` shows the seed-0 start), a seed-0 ViT-S/16 .pth
    (50% mask) and phase 6's kind of JPEG tree for lost."""
    from vipers_torch.core.checkpoint import (export_resnet, export_vit_torchvision,
                                              save_torch_state_dict)
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    data = os.path.join(root, "data")
    imagefolder_tree(data, DDP_TRAIN, DDP_VAL, seed=21)
    voc = os.path.join(root, "VOC2007")
    voc_tree(voc, DDP_JPEG, seed=21)
    sweep = os.path.join(root, "sweep")
    os.makedirs(sweep)
    resnet = os.path.join(sweep, "resnet50_epoch_0_pruning_iteration_00.pth")
    save_torch_state_dict(export_resnet(params, None, masks, bake_masks=False), resnet)
    start = os.path.join(root, "resnet50_bn3.pth")
    save_torch_state_dict(export_resnet(bn_biases_plus3(params)), start)
    return (data, voc, sweep, resnet, start) + mp_inputs(root)


def mp_inputs(root):
    """The model-parallel runs' inputs: a seed-0 ViT-S/16 .pth (50% mask),
    ImageFolder trees of 2 global batches for TP and PP and ``MP_VAL`` val
    images, and a VOC tree of ``SP_JPEG`` fixture JPEGs. Returns (vit, mp)."""
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model

    spec = build_model("vit_s_16")
    params, masks = seeded_pruned(spec)
    vit = os.path.join(root, "vit_s_16.pth")
    save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), vit)
    mp = {}
    for name, n_train in (("tp", 2 * TP_BATCH), ("pp", 2 * PP_BATCH)):
        mp[name] = os.path.join(root, f"data_{name}")
        imagefolder_tree(mp[name], n_train, MP_VAL, seed=22)
    mp["voc"] = os.path.join(root, "VOC_sp")
    voc_tree(mp["voc"], SP_JPEG, seed=22)
    return vit, mp


def mp_stages(out, vit, mp, ranks=1):
    """The model-parallel runs at the global batches ``TP_BATCH`` and
    ``PP_BATCH`` over ``ranks`` processes (1: the one process, without the
    layout flags; more: 2 model or pipe ranks, the rest data ranks):
    ``train --model-parallel 2`` and ``train --pipeline-parallel 2
    --pp-microbatch 128`` (SNIP: the masks are the one process's bit for
    bit; LRR's masks would follow the trained weights, which differ in
    their last bits), ``lost --sequence-parallel`` (ViT-S/16 f32,
    dino_vit_small bf16) and the ViT-S/16 features under sequence
    parallelism."""
    multi = ranks > 1
    data = max(ranks // 2, 1)
    common = ["--num-classes", "1000", "--workers", "4", "--print-freq", "0", "--epochs", "1",
              "--lr", "0.01", "--amp", "--pruning-method", "snip",
              "--target-sparsity", str(SPARSITY)]
    pp = ["--pipeline-parallel", "2", "--pp-microbatch", str(PP_MICROBATCH)]
    if data > 1:
        pp += ["--pp-data", str(data)]
    sp = ["--sequence-parallel"] if multi else []
    return [
        ["train_tp", ["train", "--model", "vit_b_16", *common, "--data-path", mp["tp"],
                      "--batch-size", str(TP_BATCH // data), "--output-dir",
                      os.path.join(out, "tp")] + (["--model-parallel", "2"] if multi else [])],
        ["train_pp", ["train", "--model", "vit_b_16", *common, "--data-path", mp["pp"],
                      "--batch-size", str(PP_BATCH // data), "--output-dir",
                      os.path.join(out, "pp")] + (pp if multi else [])],
        ["lost_sp_vit", ["lost", "--model", "vit_s_16", "--data-path", mp["voc"],
                         "--checkpoint", vit, "--batch-size", str(SP_JPEG), "--workers", "4",
                         "--output-dir", os.path.join(out, "sp_vit"), *sp]],
        ["lost_sp_dino", ["lost", "--arch", "dino", "--model", "dino_vit_small", "--dtype",
                          "bf16", "--data-path", mp["voc"], "--batch-size", str(SP_JPEG),
                          "--workers", "4", "--output-dir", os.path.join(out, "sp_dino"), *sp]],
        ["sp_features", ["sp_features", vit, mp["voc"], os.path.join(out, "sp_features.pt"),
                         multi]],
    ]


def ddp_stages(out, batch, data, voc, sweep, resnet, start, vit, mp, ranks=1):
    """The CLI runs at the per-process ``batch`` (``lost`` at twice it: 32 a
    rank, 64 the process), then ``mp_stages``."""
    common = ["--data-path", data, "--num-classes", "1000", "--batch-size", str(batch),
              "--workers", "4", "--print-freq", "0", "--epochs", "1", "--lr", "0.01"]
    return [
        ["train_resnet", ["train", "--model", "resnet50", *common, "--pruning-method", "snip",
                          "--target-sparsity", str(SPARSITY), "--resume", start,
                          "--output-dir", os.path.join(out, "resnet")]],
        ["train_vit", ["train", "--model", "vit_b_16", *common, "--amp", "--pruning-method",
                       "snip", "--target-sparsity", str(SPARSITY),
                       "--output-dir", os.path.join(out, "vit")]],
        ["evaluate", ["evaluate", "--model", "resnet50", *common, "--models-path", sweep,
                      "--output-dir", os.path.join(out, "eval")]],
        ["quantize", ["quantize", "--model", "resnet50", *common, "--mode", "ptq",
                      "--calibration-batches", "2", "--resume", resnet,
                      "--output-dir", os.path.join(out, "quant")]],
        ["lost", ["lost", "--model", "vit_s_16", "--data-path", voc, "--checkpoint", vit,
                  "--dtype", "bf16", "--batch-size", str(2 * batch),
                  "--workers", "4", "--output-dir", os.path.join(out, "lost")]],
    ] + mp_stages(out, vit, mp, ranks)


def launch_ddp_ranks(root, stages, world=DDP_WORLD):
    """The children as ``world`` ranks running ``stages``, started: they
    import and make their CUDA context, then wait for ``join_ddp_ranks``.
    With one card the ranks share it over gloo; with ``world`` cards each
    takes its own, over NCCL (``maybe_initialize_distributed``'s choice).
    Returns their handle."""
    import subprocess

    out = os.path.join(root, "ranks")
    cfg = os.path.join(root, "ranks.json")
    with open(cfg, "w") as f:
        json.dump({"stages": stages}, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    go = os.path.join(root, "go")
    t_launch = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", DDP_CHILD, cfg, out, go], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return {"procs": procs, "out": out, "go": go, "t_launch": t_launch}


def stop_ddp_ranks(handle):
    """Kill the children that still run (after a failure)."""
    for p in handle["procs"]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def join_ddp_ranks(handle):
    """Let the children run their stages and wait for them; returns (each
    rank's results, wall seconds from the go)."""
    t0 = time.perf_counter()
    open(handle["go"], "w").close()
    t_end = {}
    try:
        for r, p in enumerate(handle["procs"]):
            log, _ = p.communicate(timeout=900)
            t_end[r] = time.time()
            assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    finally:  # a failure leaves no process behind
        stop_ddp_ranks(handle)
    secs = time.perf_counter() - t0
    res = []
    world = len(handle["procs"])
    for r in range(world):
        with open(f"{handle['out']}_{r}.json") as f:
            res.append(json.load(f))
        assert (res[-1]["rank"], res[-1]["world"]) == (r, world), res[-1]
        res[-1]["t_launch"], res[-1]["t_end"] = handle["t_launch"], t_end[r]
    return res, secs


def load_pth(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def ddp_compare(root, ranks, single, tag="phase 21"):
    """The ranks' artifacts against the one-process ones, for the stages
    that ran (the tolerances of the JAX package's multi-process test;
    SNIP's masks, ``preds.pkl`` and the results txt equal). Every check
    runs and prints; the first failure is raised at the end."""
    import pickle

    m, s = os.path.join(root, "ranks"), os.path.join(root, "single")
    ran = single[0]
    world = len(ranks)
    failures = []

    def check(fn, *args):
        try:
            fn(*args)
        except AssertionError as e:
            print(f"{tag} FAILED {fn.__name__}: {e!r}"[:2000])
            failures.append(e)

    def own(lines):
        return [l for l in lines if not l.startswith(("| distributed", "train mesh"))]

    def printed_lines():
        for stage in ("train_resnet", "train_vit", "evaluate", "quantize", "train_tp",
                      "train_pp"):
            if stage not in ran:
                continue
            want = own(ran[stage]["lines"])
            for r in ranks:
                got = own(r[stage]["lines"])
                assert got == want, (stage, r["rank"], got, want)
        for r in ranks:
            assert (f"train mesh: data={world // 2} x model=2 over {world} devices, {world} "
                    "processes") in r["train_tp"]["lines"], r["train_tp"]["lines"]

    def checkpoint(sub, tol):
        a, b = load_pth(os.path.join(s, sub)), load_pth(os.path.join(m, sub))
        assert a["model"].keys() == b["model"].keys() and a["step"] == b["step"] == 2
        worst, bad, rel = 0.0, [], []
        for k, v in a["model"].items():
            w = b["model"][k]
            assert v.shape == w.shape, (sub, k, v.shape, w.shape)  # one process's layout
            if k.endswith("_mask") or k.endswith("num_batches_tracked"):
                assert torch.equal(v, w), (sub, k)  # SNIP's masks from the global batch
                continue
            d = (w.double() - v.double()).abs()
            excess = float((d - (tol["atol"] + tol["rtol"] * v.double().abs())).max())
            rel.append((float(d.norm() / max(float(v.double().norm()), 1e-30)), k))
            if excess > 0:
                bad.append((excess, k))
            worst = max(worst, float(d.max()))
        rel.sort(reverse=True)
        print(f"{tag} {sub.split('/')[0]}: {world} ranks vs 1 process after 2 steps, masks "
              f"equal, worst difference {worst:.3g}, worst relative L2 {rel[:3]}, "
              f"{len(bad)} tensors past rtol {tol['rtol']} / atol {tol['atol']}: "
              f"{sorted(bad, reverse=True)[:5]}")
        assert not bad, sub

    def evaluate_rows():
        rows = [open(os.path.join(d, "eval", "resnet50_dilation_1.txt")).read().split("\n")
                for d in (s, m)]
        assert [r.split()[0::2] for r in rows[0]] == [r.split()[0::2] for r in rows[1]]
        for a, b in zip(*rows):
            if a and not a.startswith("test/loss"):
                assert a == b, (a, b)

    def observers():
        qa = load_pth(os.path.join(s, "quant", "quantized_post_train_model.pth"))["observers"]
        qb = load_pth(os.path.join(m, "quant", "quantized_post_train_model.pth"))["observers"]
        assert qa.keys() == qb.keys() and len(qa) >= 100
        worst = max(abs(float(qa[k][e]) - float(qb[k][e])) / max(abs(float(qa[k][e])), 1e-6)
                    for k in qa for e in ("min", "max"))
        print(f"{tag} quantize observers ({len(qa)}): worst relative difference {worst:.3g}")
        assert worst <= 1e-4, worst

    def lost_outputs(sub, what):
        preds = [pickle.load(open(os.path.join(d, sub, "preds.pkl"), "rb")) for d in (s, m)]
        same = sum(preds[0][k] == preds[1].get(k) for k in preds[0])
        txt = [open(os.path.join(d, sub, "results_iteration_00.txt")).read() for d in (s, m)]
        print(f"{tag} {what} against 1 process: boxes equal on "
              f"{same}/{len(preds[0])}, results txt {'equal' if txt[0] == txt[1] else 'differ'}")
        assert preds[0].keys() == preds[1].keys() and same == len(preds[0]) and txt[0] == txt[1]

    def sp_feature_scale():
        one = torch.load(os.path.join(s, "sp_features.pt"))
        two = torch.load(os.path.join(m, "sp_features.pt"))
        worst = max(float((b - a).abs().max() / a.abs().max()) for a, b in zip(one, two))
        print(f"{tag} sequence parallel, ViT-S/16 f32 LOST features of {len(one)} JPEGs "
              f"({[tuple(a.shape) for a in one][:2]} ...), {world} ranks against 1 process: worst "
              f"difference {worst:.3g} of the features' scale (limit 1e-3)")
        assert len(one) == len(two) == SP_JPEG and worst <= 1e-3, worst

    check(printed_lines)
    for stage, sub in (("train_resnet", "resnet/resnet50_epoch_0_snip_0.5.pth"),
                       ("train_vit", "vit/vit_b_16_epoch_0_snip_0.5.pth"),
                       ("train_tp", "tp/vit_b_16_epoch_0_snip_0.5.pth"),
                       ("train_pp", "pp/vit_b_16_epoch_0_snip_0.5.pth")):
        if stage in ran:
            check(checkpoint, sub, dict(rtol=5e-2, atol=3e-3))
    if "evaluate" in ran:
        check(evaluate_rows)
        check(observers)
        check(lost_outputs, "lost", "lost, 2 ranks at B=32 against 1 process at B=64")
    check(lost_outputs, "sp_vit", f"lost --sequence-parallel, ViT-S/16 f32 on {world} ranks")
    check(lost_outputs, "sp_dino",
          f"lost --sequence-parallel, dino_vit_small bf16 on {world} ranks")
    check(sp_feature_scale)
    if failures:
        raise failures[0]


def model_parallel_launches(runs, data=1):
    """The model-parallel stages' launches held to their counts on each
    rank ({"rank0", ..., "single"}; ``data`` data ranks); returns them by
    kernel row, the who prefixed with the path ("tp rank0", ...). TP: rows
    7-8 in every block of the 2 steps at 6 heads a rank (12 at the
    process), row 4 at F = 1536 a rank in the eval's 12 blocks; PP: rows
    7-8 in each stage's 6 blocks x 2 microbatches x 2 steps, row 4 in its 6
    blocks of the eval (the process: 12 blocks, one batch); row 4 only
    where a forward's rows pass the block rule (rows % 128: 128 images of
    197 tokens, so not at 64 a data rank); SP:
    no flash and no fused-MLP launch on a rank, where the process runs
    both."""
    steps, mbs = 2, PP_BATCH // PP_MICROBATCH
    tokens = 197  # ViT-B/16 at 224
    rows = {}

    def fused(images):
        return images * tokens % 128 == 0

    def put(name, who, n):
        rows.setdefault(name, {})[who] = n

    for who, r in runs.items():
        one = who == "single"
        tp, pp = r["train_tp"], r["train_pp"]
        assert tp["rows_7_8"] == [12 * steps] * 2, (who, tp)
        eval_rows = MP_VAL if one else MP_VAL // data
        assert tp["row_4_d768"] == 12 * fused(eval_rows) and tp["row_1_any"] == 0, (who, tp)
        blocks = 12 if one else 6
        assert pp["rows_7_8"] == [blocks * (1 if one else mbs) * steps] * 2, (who, pp)
        pp_eval = MP_VAL if one else PP_MICROBATCH // data
        assert pp["row_4_d768"] == blocks * fused(pp_eval), (who, pp)
        for path, r_ in (("tp", tp), ("pp", pp)):
            put("attention_train_fwd[bf16]", f"{path} {who}", r_["rows_7_8"][0])
            put("attention_train_bwd[bf16]", f"{path} {who}", r_["rows_7_8"][1])
            put("fused_ln_fc1_gelu[bf16, D=768]", f"{path} {who}", r_["row_4_d768"])
        vit, dino = r["lost_sp_vit"], r["lost_sp_dino"]
        if one:
            assert vit["row_1_any"] > 0 and dino["row_1_any"] > 0 and dino["row_4_any"] > 0
        else:
            assert vit["row_1_any"] == vit["row_4_any"] == 0, (who, vit)
            assert dino["row_1_any"] == dino["row_4_any"] == 0, (who, dino)
        put("flash_attention_fwd[f32]", f"sp vit_s_16 {who}", vit["row_1_any"])
        put("flash_attention_fwd[bf16]", f"sp dino_vit_small {who}", dino["row_1_any"])
        put("fused_ln_fc1_gelu[bf16]", f"sp dino_vit_small {who}", dino["row_4_any"])
    return rows


def ddp_phase(card):
    """Phase 21 (see the module docstring). Returns {row: {"rank0", "rank1",
    "single"} launches} for rows 1, 4 and 7-8."""
    import tempfile

    t_phase = time.time()
    laps = {}

    def lap(what, t0):
        laps[what] = round(time.time() - t0, 1)
        return time.time()

    t = time.time()
    spec, params, masks = ddp_resnet()
    nccl_one_rank(card, spec, params, masks)
    t = lap("one-rank NCCL", t)
    root = tempfile.mkdtemp(prefix="vipers_torch_ddp_")
    handle = None
    try:
        inputs = ddp_inputs(root, params, masks)
        t = lap("inputs", t)
        # the children import and make their CUDA contexts meanwhile
        handle = launch_ddp_ranks(root, ddp_stages(os.path.join(root, "ranks"), DDP_BATCH,
                                                   *inputs, ranks=DDP_WORLD))
        bn_order_witness(card, spec, params, masks)
        t = lap("witness", t)
        snip_global_batch_memory(card, spec, params)
        t = lap("SNIP memory", t)
        ranks, t_ranks = join_ddp_ranks(handle)
        t = lap("2 ranks", t)
        # the one process at the global batch: this one (no process group)
        t0 = time.perf_counter()
        single = [run_ddp_stages(ddp_stages(os.path.join(root, "single"),
                                            DDP_WORLD * DDP_BATCH, *inputs))]
        t_single = time.perf_counter() - t0
        t = lap("1 process", t)
        for r in ranks:
            assert any("gloo on cuda" in l for l in r["train_resnet"]["lines"]), r
        print(f"phase 21 gloo collectives on CUDA tensors: {ranks[0]['gloo_cuda']}; rank 1's "
              f"send_recv {ranks[1]['gloo_cuda']['send_recv']}; "
              f"the pipeline's send/recv route on each rank "
              f"{[r['p2p_route'] for r in ranks]} (host: through pinned host memory)")
        ddp_compare(root, ranks, single)
        t = lap("compare", t)
    finally:
        if handle:
            stop_ddp_ranks(handle)
        remove_later(root)
    runs = {f"rank{r['rank']}": r for r in ranks}
    runs["single"] = single[0]
    steps = DDP_TRAIN // (DDP_WORLD * DDP_BATCH)
    rows = {"attention_train_fwd[bf16]": {}, "attention_train_bwd[bf16]": {},
            "flash_attention_fwd[bf16]": {}, "fused_ln_fc1_gelu[bf16]": {}}
    for who, r in runs.items():
        fwd, bwd = r["train_vit"]["rows_7_8"]
        assert fwd == bwd == 12 * steps, (who, fwd, bwd)  # 12 blocks a step, every rank
        assert r["train_resnet"]["rows_7_8"] == [0, 0] and r["train_resnet"]["row_1"] == 0
        lost = r["lost"]
        assert lost["row_1"] == lost["row_4"] == 12 * lost["batches"] > 0, (who, lost)
        rows["attention_train_fwd[bf16]"][who] = fwd
        rows["attention_train_bwd[bf16]"][who] = bwd
        rows["flash_attention_fwd[bf16]"][who] = lost["row_1"]
        rows["fused_ln_fc1_gelu[bf16]"][who] = lost["row_4"]
    mp_rows = model_parallel_launches(runs)
    for name, got in mp_rows.items():
        rows.setdefault(name, {}).update(got)
    for stage in ("train_resnet", "train_vit", "evaluate", "quantize", "lost", "train_tp",
                  "train_pp", "lost_sp_vit", "lost_sp_dino", "sp_features"):
        print(f"phase 21 {stage}: 2 ranks on one card "
              f"{max(r[stage]['s'] for r in ranks):.1f} s, 1 process "
              f"{single[0][stage]['s']:.1f} s (one card shared: not a speed-up; to the first "
              f"train batch: ranks {[r[stage]['to_data_s'] for r in ranks]}, 1 process "
              f"{single[0][stage]['to_data_s']}) ({card})")
    print(f"phase 21 launches on each rank: {rows}; {t_ranks:.1f} s the 2 ranks from the go "
          f"(child processes, ready {[round(r['t_ready'] - r['t_launch'], 1) for r in ranks]} s "
          f"after their launch, during the witness and the SNIP memory run; rank 0's exit "
          f"{ranks[0]['t_end'] - ranks[0]['t_exit']:.1f} s after its last stage), "
          f"{t_single:.1f} s the 1 process (this one); laps {laps}")
    print(f"phase 21 data and model parallelism: {time.time() - t_phase:.1f} s")
    return rows


def nccl_model_parallel(card, world):
    """``python chip_smoke.py --nccl N``, on a host with N cards: phase
    21's model-parallel runs (``mp_stages``) as N ranks, one card each,
    over NCCL (``--model-parallel 2`` and ``--pipeline-parallel 2`` with N
    / 2 data ranks, ``lost --sequence-parallel`` over all N), against one
    process on card 0 at the same global batches; the same checks and
    launch counts, each stage's seconds. Not part of the one-card run."""
    import tempfile

    from vipers_torch.ops import _build

    _build.build(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_packed",
                  "fused_mlp", "attention_train", "splash_attention"])
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="vipers_torch_nccl_")
    handle = None
    try:
        vit, mp = mp_inputs(root)
        handle = launch_ddp_ranks(root, mp_stages(os.path.join(root, "ranks"), vit, mp, world),
                                  world)
        ranks, t_ranks = join_ddp_ranks(handle)
        t0 = time.perf_counter()
        single = [run_ddp_stages(mp_stages(os.path.join(root, "single"), vit, mp))]
        t_single = time.perf_counter() - t0
        for r in ranks:
            assert any("nccl on cuda" in l for l in r["train_tp"]["lines"]), r["train_tp"]
        tag = f"NCCL {world} cards"
        ddp_compare(root, ranks, single, tag=tag)
    finally:
        if handle:
            stop_ddp_ranks(handle)
        remove_later(root)
        wait_removals()
    runs = {f"rank{r['rank']}": r for r in ranks}
    runs["single"] = single[0]
    rows = model_parallel_launches(runs, data=world // 2)
    for stage in ("train_tp", "train_pp", "lost_sp_vit", "lost_sp_dino", "sp_features"):
        print(f"{tag} {stage}: {world} ranks {max(r[stage]['s'] for r in ranks):.1f} s "
              f"(each {[round(r[stage]['s'], 1) for r in ranks]}), 1 process "
              f"{single[0][stage]['s']:.1f} s ({card})")
    print(f"{tag} launches: {rows}; p2p routes {[r['p2p_route'] for r in ranks]}; "
          f"{t_ranks:.1f} s the ranks from the go, {t_single:.1f} s the 1 process; "
          f"{time.time() - t_phase:.1f} s in all")
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--nccl" in sys.argv:
        from vipers_torch.core.device import card_line

        world = int(sys.argv[sys.argv.index("--nccl") + 1])
        if torch.cuda.device_count() < world:
            print(f"chip_smoke --nccl {world}: {torch.cuda.device_count()} cards",
                  file=sys.stderr)
            return 2
        print(card_line())
        return nccl_model_parallel(card_line(), world)
    from vipers_torch.core.device import card_line
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.discovery.lost import lost_core
    from vipers_torch.ops import _build
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.ops import splash_attention as sa
    from vipers_torch.pruning import init_masks, magnitude_prune

    t_start = time.time()
    laps = [t_start]

    def lap(phase):
        """Prints the seconds since the last phase ended."""
        laps.append(time.time())
        print(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s")

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    # cuBLAS TF32 off keeps the f32 plain versions exact; cuDNN's is on by
    # default, so the f32 patch conv runs in TF32
    print(f"TF32: torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.time()
    logs = _build.build(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_packed",
                         "fused_mlp", "attention_train", "splash_attention"],
                        ptxas_verbose=True)
    print(f"build {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line:  # which instance the next lines are
                print(f"  {name}: {line.strip()[:170]}")
            elif "registers" in line or "spill" in line or "serialized" in line:
                print(f"  {name}: {line.strip()}")

    lap(2)
    # 3. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    # row 1 at the LOST path's shape: B*H = 128*6, T = 896 (769 tokens
    # seq-padded; bucket pad from grid row 29 and column 22 on every other image)
    kernels = [*(check_flash_at(fa, dt, gen, (BATCH, 6, 896, 64), (32, 24), (29, 22))
                 for dt in (torch.float32, torch.bfloat16)),
               check_flash_bwd(fa, torch.float32, gen), check_flash_bwd(fa, torch.bfloat16, gen),
               check_flash_packed(fa, torch.float32, gen),
               check_flash_packed(fa, torch.bfloat16, gen),
               check_fused_mlp(fm, gen), *check_attention_train(at, gen),
               *check_softmax_variants(at, gen), *check_splash(sa, gen)]
    check_attention_train_rounds(at, gen)
    check_fused_mlp_wide(fm, gen)
    # the ViT family's rows: row 1 at hd 80, row 4 at D = 768, 1024, 1280
    # at hd 80, vit_h_14's LOST shape: B*H = 128*16, T = 1024 (the 504x392
    # VOC bucket at patch 14: 1009 tokens, seq-padded), one image attending no key
    for dtype in (torch.float32, torch.bfloat16):
        kernels.append(check_flash_at(fa, dtype, gen, (BATCH, 16, 1024, 80), (28, 36), (25, 33),
                                      "hd80", all_invalid=True))
        torch.cuda.empty_cache()
    kernels += check_fused_mlp_family(fm, gen)
    torch.cuda.empty_cache()
    # vit_h_14's train rows: the training kernels (rows 5-8) at its 224x224
    # shape and the flash backward (rows 12-13) at its 392x392 shape, hd 80
    kernels += check_attention_train(at, gen, shape=(32, 16, 384, 80), n_valid=257, ragged=150)
    for dtype in (torch.float32, torch.bfloat16):
        kernels.append(check_flash_bwd(fa, dtype, gen, shape=(16, 16, 896, 80), n_valid=785,
                                       ragged=400))
        torch.cuda.empty_cache()

    lap(3)
    # 4. main path
    t0 = time.time()
    spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W))
    params, masks = seeded_pruned(spec)
    kept = sum(int(m.sum()) for m in masks.values())
    total = sum(m.numel() for m in masks.values())
    print(f"vit_s_16 {H}x{W}: {total} prunable weights, sparsity "
          f"{100 * (1 - kept / total):.2f}% (set-up {time.time() - t0:.1f} s)")
    rng = np.random.default_rng(1)
    exact_hw = [(H, W)] * BATCH
    mixed_hw = [(H, W)] * 8 + [(int(rng.integers(449, H + 1)), int(rng.integers(321, W + 1)))
                               for _ in range(BATCH - 8)]
    buckets = {"exact": (make_images(rng, exact_hw), exact_hw),
               "mixed": (make_images(rng, mixed_hw), mixed_hw)}
    extractors = {name: LostFeatureExtractor(spec, params, masks, compute_dtype=dt)
                  for name, dt in (("f32", None), ("bf16", torch.bfloat16))}
    inputs = {(e, b): extractors[e].prepare_batch(imgs, PATCH, exact_hw=hw)
              for e in extractors for b, (imgs, hw) in buckets.items()}
    assert inputs["f32", "exact"][2] is None and inputs["f32", "exact"][4] is None
    assert inputs["f32", "mixed"][2] is not None and inputs["f32", "mixed"][4] is not None
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    torch.cuda.synchronize()

    counters = (fa.LAUNCHES, fa.PACKED_LAUNCHES, fa.BWD_LAUNCHES, fm.LAUNCHES,
                fm.WIDTH_LAUNCHES, at.LAUNCHES, sa.LAUNCHES)
    reset_counts(*counters)
    outs = {key: pipes[key[0]](*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd[f32]": fa.LAUNCHES["float32"],
                "flash_attention_fwd[bf16]": fa.LAUNCHES["bfloat16"],
                "fused_ln_fc1_gelu[bf16]": fm.LAUNCHES["bfloat16"]}
    print(f"LOST path launches (4 forwards, 12 blocks each): {launches}")
    assert not any(at.LAUNCHES.values()), at.LAUNCHES
    assert not any(fa.PACKED_LAUNCHES.values()), fa.PACKED_LAUNCHES
    assert not any(fa.BWD_LAUNCHES.values()), fa.BWD_LAUNCHES
    layers = spec.cfg.num_layers
    assert launches == {"flash_attention_fwd[f32]": 2 * layers,
                        "flash_attention_fwd[bf16]": 2 * layers,
                        "fused_ln_fc1_gelu[bf16]": 2 * layers}, launches

    gh, gw = H // PATCH, W // PATCH
    for (e, b), (box, seed, bg) in outs.items():
        box, seed, bg = box.cpu(), seed.cpu(), bg.cpu()
        assert box.shape == (BATCH, 4) and seed.shape == (BATCH,) and bg.shape == (BATCH,)
        assert bool(((box[:, 0] <= box[:, 1]) & (box[:, 1] <= gh)
                     & (box[:, 2] <= box[:, 3]) & (box[:, 3] <= gw)).all())
        assert bool(((seed >= 0) & (seed < gh * gw)).all())
        feats = extractors[e].batched_features(*inputs[e, b])
        assert feats.shape == (BATCH, gh * gw, 384) and bool(torch.isfinite(feats).all())
        print(f"pipeline [{e}, {b}] boxes ok, seed in background {int(bg.sum())}/{BATCH}, "
              f"mean box area {float(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).float().mean()):.1f} patches")
    agree = {b: float((outs["f32", b][0] == outs["bf16", b][0]).all(dim=1).float().mean())
             for b in buckets}
    print(f"bf16 vs f32 on the card: boxes equal on {agree}")

    for e, ex in extractors.items():
        for b, (imgs, hw) in buckets.items():
            compare_with_cpu(f"{e}, {b}", spec, params, masks, ex.compute_dtype, ex,
                             imgs, hw, lost_core)

    # throughput at B=128 (exact bucket) and p50 latency at B=1, bf16 and f32
    for e, ex in extractors.items():
        one = ex.prepare_batch(buckets["exact"][0][:1], PATCH, exact_hw=exact_hw[:1])
        ips, p50 = throughput(pipes[e], inputs[e, "exact"], one)
        print(f"throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{p50:.2f} ms at B=1 ({card})")

    lap(4)
    # 5. packed LOST path
    launches.update(packed_lost_phase(card, spec, extractors, buckets, outs["f32", "mixed"],
                                      lost_core))

    lap(5)
    # 6. JPEG -> boxes -> CorLoc through the CLI
    jpeg = jpeg_lost_phase(card, counters)

    lap(6)
    # 7. train path at 224x224: the training attention kernels
    tl = train_phase(card, counters, TRAIN_HW, N_CPU, lrr=True)
    launches.update({k: tl[k] for k in ("attention_train_fwd[bf16]", "attention_train_bwd[bf16]")})

    lap(7)
    # 8. train path at 384x384: the flash forward and backward kernels
    tl = train_phase(card, counters, TRAIN_HW_FLASH, 2, lrr=False)
    launches.update({k: tl[k] for k in ("flash_attention_bwd[f32]", "flash_attention_bwd[bf16]")})

    lap(8)
    # 9. the A/B tools
    launches.update(tools_phase(counters))

    lap(9)
    # 10. the ViT family on the LOST path
    family_rows, family_cli_run = family_phase(card, counters, lost_core)
    launches.update(family_rows)

    lap(10)
    # 11. vit_h_14 pruned and trained: the hd-80 training kernels and flash
    # backward, SNIP
    launches.update(vit_h_phase(card, counters))
    for key in [k for k in INIT_CACHE if k[0] == "vit_h_14"]:
        del INIT_CACHE[key]  # no later phase builds vit_h_14
    lap(11)
    import tempfile

    # phase 12's ViT-B/16 checkpoint (for phase 18) and phase 13's ResNet-50
    # (for phase 14) live here until the last phase
    keep = tempfile.mkdtemp(prefix="vipers_torch_keep_")
    try:
        # 12. prune -> train -> evaluate -> LOST through the CLI, ViT-B/16
        vit_b_pth = os.path.join(keep, "vit_b_16_iteration_01.pth")
        train_cli_runs = train_cli_phase(card, counters, keep_pth=vit_b_pth)
        lap(12)
        # 13. the CNN families (ResNet-50, VGG16) through train, evaluate, lost
        resnet_pth = os.path.join(keep, "resnet50_iteration_01.pth")
        cnn_phase(card, counters, keep_pth=resnet_pth)
        lap(13)
        # 14. Swin-V2-T through train, evaluate, lost; the per-image LOST path
        swin_phase(card, counters, resnet_pth)
        os.remove(resnet_pth)
        lap(14)
        # 15. explain and model-vs-human: rows 1 and 12-13 f32 at explain-eval's
        # shape, explain-eval, explain, card vs CPU, mvh
        explain_rows, explain_launches = explain_phase(card, counters, fa, gen)
        kernels += explain_rows
        launches.update(explain_launches)
        lap(15)
        # 16. the DINO ViTs through LOST (--arch dino, --dinoseg) and cluster;
        # VGG16 training with its dropout; the ViT under attention dropout
        dino_rows, dino_launches = dino_phase(card, counters, gen, lost_core)
        kernels += dino_rows
        launches.update(dino_launches)
        lap(16)
        # 17. structured slimming: slim -> lost (rows 1 and 4 at slim shapes),
        # train --resume (rows 7-8 at 6 heads), evaluate; the CNN families
        slim_rows, slim_launches = slim_phase(card, counters, gen)
        kernels += slim_rows
        launches.update(slim_launches)
        lap(17)
        # 18. int8 quantization: the int32 accumulators card vs CPU, lost
        # --dtype int8 (row 1 in every block, row 4 off), quantize PTQ of
        # phase 12's checkpoint -> lost --dtype int8, PTQ and QAT on the
        # quantized_ CNNs
        ptq_pth = os.path.join(keep, "vit_b_16_ptq.pth")
        mb_ptq_pth = os.path.join(keep, "quantized_mobilenet_v2_ptq.pth")
        quant_rows, quant_launches = quantize_phase(card, counters, gen, lost_core, vit_b_pth,
                                                    keep_ptq=ptq_pth, keep_mb_ptq=mb_ptq_pth)
        kernels += quant_rows
        launches.update(quant_launches)
        lap(18)
        # 19. serving export: the ViT-B/16 LOST program (bf16, f32, int8) as
        # torch.export artifacts replayed in a fresh process (rows 1 and 4 as
        # custom ops, counted there), ResNet-50 CNN LOST, ViT-B/16 classify,
        # bench_export
        export_rows, export_launches, export_runs = export_phase(card, counters, gen,
                                                                 vit_b_pth, ptq_pth)
        kernels += export_rows
        launches.update(export_launches)
        lap(19)
        # 20. mobilenet_v2 through lost (bf16, f32, exact shapes, int8 from
        # phase 18's PTQ .pth) and explain-eval, DINO explain-eval (rows 1 and
        # 12-13 f32 at B*H = 1*6), lost --visualize (rows 1 and 4 at B = 1),
        # train --profile-dir and --debug-nans
        debug_rows, debug_launches = debug_surface_phase(card, counters, gen, lost_core,
                                                         mb_ptq_pth)
        kernels += debug_rows
        launches.update(debug_launches)
        lap(20)
        # 21. data parallelism: a one-rank NCCL step, and train, evaluate, quantize and
        # lost as 2 ranks sharing the card over gloo against one process
        ddp_runs = ddp_phase(card)
        lap(21)
    finally:
        remove_later(keep)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if jpeg:  # the CLI runs' launches beside the pipeline's, on the rows they drove
        for k in kernels:
            cli = {"flash_attention_fwd[bf16]": ("bf16", "flash"),
                   "flash_attention_fwd[f32]": ("f32", "flash"),
                   "flash_attention_packed[bf16]": ("bf16 packed", "packed"),
                   "fused_ln_fc1_gelu[bf16]": ("bf16", "fused_mlp")}.get(k["name"])
            if cli:
                k["cli_launches"] = jpeg[cli[0]][cli[1]]
    for k in kernels:  # phase 12's train, evaluate runs, on the rows they drove
        if k["name"] in train_cli_runs:
            k["train_cli_launches"] = train_cli_runs[k["name"]]
    for k in kernels:  # the exported ViT-B/16 bf16 program's batch, on the D = 768 row
        if k["name"] in export_runs:
            k["export_launches"] = export_runs[k["name"]]
    for k in kernels:  # phase 21's runs on each rank, on the rows they drove
        if k["name"] in ddp_runs:
            k["ddp_launches"] = ddp_runs[k["name"]]
    if family_cli_run:  # vit_b_16's CLI run, on the D = 768 row it drove
        for k in kernels:
            if k["name"] == "fused_ln_fc1_gelu[bf16, D=768]":
                k["cli_launches"] = family_cli_run["fused_mlp[D=768]"]

    wait_removals()  # the temporary trees' unlinks, on threads since their phases
    print(f"chip_smoke total {time.time() - t_start:.1f} s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the contract's keys first, then a row's own (the fused MLP's rate and design)
    print(json.dumps({"kernels": [{**{k: kd[k] for k in keys}, **kd} for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
