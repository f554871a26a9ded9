#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines, the first failure ending the run
with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every CUDA kernel of the paths from the sources in
   tinyedm_tpu_torch/csrc (into tinyedm_tpu_torch/build/), and the nvJPEG
   binding of phase 30, one nvcc per source, all started together; ptxas's
   registers and spills of the flash backward and the block libraries'
   kernels;
3. fused forward kernel vs plain: the cosine-attention forward kernel
   against its plain PyTorch version at the sampling paths' shapes (CIFAR-10
   at batch 128, 4 heads of 64; ImageNet-512 at batch 32, 4 heads of 144 at
   n = 256 and of 192 at n = 64), bf16 (max abs <= 8e-3) and fp32 (atol =
   rtol = 1e-5), plus odd shapes (hd 20 to 256, among them 144 and 192 at
   n = 33 and 65); times of the kernel, the plain version and one PyTorch
   library call, beside the card's bound. bf16 runs the products on the
   tensor cores (mma.sync), fp32 on the CUDA cores;
4. fused backward kernel vs plain: the same for the backward kernel at the
   training paths' shapes (CIFAR-10 batch 256, the ImageNet-512 microbatch of
   32), bf16 (relative L2 <= 1e-3) and fp32 (relative L2 <= 1e-5), plus odd
   shapes; the forward kernel against its
   plain version again at these shapes, with phase 3's limits;
5. flash kernels vs plain: the flash forward and backward kernels (the
   use_pallas_attention route) against flash_attention_plain and its
   backward at the ImageNet-512 widths above its attention levels (4 heads
   of 96 at n = 1024, of 48 at n = 4096) and at 4 heads of 64 (n = 1024,
   4096), batch 32 (the correctness check at n = 4096 at batch 8: the plain
   version holds (b, heads, n, n) fp32), with phase 3's and 4's limits, plus
   odd shapes (n = 1 to 2000, hd = 20 to 256; the views of one (b, n, 3,
   heads, hd) tensor and, for the odd shapes, contiguous tensors too); times
   beside SDPA's and the bound. bf16 at n >= 2 runs the products on the tensor cores (mma.sync):
   the forward's q k^T and PV, the backward's S, dP, dq, dk and dv (p and
   ds as hi + lo bf16 pairs); fp32, and bf16 at n = 1, on the CUDA cores;
6. flash layer check: CosineAttention(use_pallas=True) in bf16 at (32, 384,
   32, 32) and (8, 192, 64, 64), forward and backward against the same
   weights with use_pallas=False (output relative L2 <= 1e-2, input gradient
   <= 2e-2), with exactly one flash forward and one flash backward call each;
7. CIFAR-10 forward: the model at full width, batch 128, bf16, seeded
   weights with gain_out = 1, fused attention against fused="off" (relative
   L2 <= 1e-2), with exactly 11 forward kernel launches;
8. CIFAR-10 Heun-32: tinyedm_tpu_torch.generate.generate() for 128 images at
   batch 128 (63 forwards, 693 launches, 128 PNGs, img/s and peak memory,
   and one weight_norm_cast launch a weight-normed layer a forward, 63 x
   115, the launches of phase 41's entries), then the same solve with fused="off" (final fp32 samples within 2e-2
   relative L2);
9. CIFAR-10 training: the recipe's train step at full width (batch 256,
   bf16, dropout 0.13, seeded synthetic images, the recipe's steady lr):
   warm-up steps, then timed steps (ms/step, samples/s, peak memory), with
   exactly 11 forward and 11 backward kernel calls per step, one
   weight_norm_cast launch each way a weight-normed layer a microbatch (115
   each way a step), finite losses,
   the EMA equal to the params after step 0 and unit per-output RMS of every
   WN weight; then one step's gradients of the WN weights fused against
   fused="off" from the same state (relative L2 <= 2e-2);
10. ImageNet-512 forward: the 272.9 M-parameter latent model at batch 32,
    bf16, 1000 classes, as phase 7, with exactly 15 fused launches (7 at
    n = 256, 8 at n = 64) and no flash launch (the default topology attends
    at 16x16 and 8x8 only);
11. ImageNet-512 Heun-32: generate() for 32 latents at batch 32 with
    --num_classes 1000 (945 launches, 32 RGBA PNGs, 63 x 195 weight_norm_cast
    launches), as phase 8;
12. ImageNet-512 training: the recipe's step (batch 128 in 4 microbatches
    of 32, uncertainty loss, two EMA profiles, per-step lr count in the
    steady range), as phase 9, with 60 forward and 60 backward fused calls
    per step, 4 x 197 weight_norm_cast launches each way a step and finite
    uncertainty;
13. block kernels vs plain: the whole-block attention forward and backward
    kernels (CosineAttention(fused="block")) against their plain versions
    at the CIFAR-10 attention widths (C 256, 4 heads of 64, n = 256 and 64;
    batch 128 forward, 256 backward), bf16 (forward relative L2 <= 1e-3 and
    every element within three bf16 ulps, 2.4e-2 of max(1, |ref|); dx, dWqkv
    and dWout relative L2 <= 1e-3) and fp32 (forward atol = rtol = 1e-5,
    backward relative L2 <= 1e-5), plus odd shapes (n = 1, 49, 50, 300;
    heads 1 and 3; C = 192 and 768 at head dim 192, C = 20 and 288); times beside
    the bound, the plain versions and the split route (cuBLAS GEMMs around
    the fused kernels of phases 3-4). bf16 runs everything on mma.sync: the attention
    cores (phases 3-4's kernels), the forward's two GEMMs (qkv, and out with
    the residual) and the backward's five (qkv, dy, dx, dWout, dWqkv), on
    64-row tiles where a block's range of k is at most 256, else 128-row
    ones; fp32 stays on the CUDA cores;
14. block layer check: CosineAttention(fused="block") in bf16 at
    (8, 256, 16, 16) and (8, 768, 8, 8), forward and backward against
    fused="off" with the same weights (output relative L2 <= 1e-2, input
    gradient <= 2e-2), with exactly one block forward and one block backward
    call at C = 256 and no kernel call at C = 768, where the JAX package's
    block_kernel_fits sends the layer down the unfused route;
15. CIFAR-10 forward with fused="block", as phase 7: exactly 11 block
    forward launches and no fused-attention launch;
16. CIFAR-10 training with fused="block", as phase 9, beside phase 9's
    numbers: exactly 11 block forward and 11 block backward calls per step;
17. Winograd: the F(2x2,3x3) conv kernel against its plain version and
    against F.conv2d at the CIFAR-10 model's 3x3 conv shapes (batch 128;
    32x32, 16x16 and 8x8 at 256 -> 256, 32x32 at 4 -> 256), bf16 (relative
    L2 <= 1e-3 against the plain version, <= 2e-2 against the fp32 direct
    conv) and fp32 (atol = rtol = 2e-5 against both, TF32 off), plus odd
    shapes (tile counts, Ci and Co off the kernel's blocks; x a view at an
    odd element offset); then
    winograd_conv3x3 once at each CIFAR-10 shape, the op's path, one launch
    each; times beside the bound (the kernel's own operations: the 16
    component products and the fp32 transform adds; the direct conv's count
    beside it), the plain version and F.conv2d; ms is the op (the wrapper's
    U transform, then the kernel), kernel_ms the kernel alone (its device
    time in a profile of the op). bf16 runs the
    component products on the tensor cores (mma.sync), fp32 on the CUDA
    cores;
18. MNIST (class-conditional, 28x28x1, 87.19 M parameters, attention at
    n = 196 and 49): the forward as phase 7 (7 + 8 launches), then CFG
    Heun-32 through generate() at batch 128 with scale 2 (63 stacked
    forwards at batch 256, 945 launches, 128 grey PNGs), the recipe's train
    step at batch 128 with dropout 0.1 and label dropout 0.1 as phase 9 (7 +
    8 forward and backward calls per step), and one make_eval_step call
    (finite sum, count = batch; fused against unfused within 2e-2);
19. CIFAR-10 DPM-Solver++(2M), 32 steps, through generate() at batch 128:
    32 forwards, 352 launches, img/s beside phase 8's;
20. CIFAR-10 churn Heun-32 (S_churn 40, S_min 0.05, S_max 50, S_noise
    1.003) through generate(): 693 launches, the fused and unfused routes
    with generators seeded alike; then the solver from one noise with one
    generator seed twice (within 1e-5) and another (more than 1e-1 away);
21. ImageNet-512 CFG Heun-32 through generate() at batch 32, scale 2 on
    (0.28, 2.9]: the stacked forward (batch 64) at the 14 half-steps inside
    the interval, 49 plain forwards, 945 launches, wall time beside phase
    11's;
22. ImageNet-512 autoguidance Heun-32: the seed-0 model guided by a seed-1
    model from save_weights (generate(..., guide_weights=...)), scale 2:
    126 forwards, 1890 launches;
23. ImageNet-64 latents (experiments/conf/imagenet.yaml): the recipe's
    train step as phase 9, 3 microbatches of 176 per step (Lightning's
    accumulate_grad_batches), lr 0.01 per step, one EMA profile, then one
    make_eval_step call with that profile;
24. the run loop at CIFAR-10 full width: synthetic CIFAR-10 pickle batches
    (5 x 1024 train images, 1000 test images) in a temporary directory, then
    tinyedm_tpu_torch.train.main on experiments/conf/cifar10.yaml (read by
    the port's YAML reader) with the data and run directories, 2 epochs,
    validation and checkpoints every epoch and the recipe's Heun-18 preview
    of 80 samples every epoch: 40 steps of 256, the fused kernels' launches
    (11 forward and 11 backward per loop step, 11 per validation batch and
    per preview forward, exactly), finite train_loss, val_loss and
    samples_per_sec rows at steps 20 and 40, one preview grid per epoch, the
    checkpoint steps that top-3 retention keeps, the latest checkpoint
    restored bit for bit (params, Adam mu, nu and count, EMA, step); one
    validation, one save and one restore timed (and the MB on disk); the
    loop's ms/step and samples/s beside phase 9's bare step; the peak
    memory; then --resume --max-epochs 3 (the resume line, step 60, finite
    losses) and generate --ckpt_path --load_ema for 128 samples (128 PNGs),
    whose samples equal bit for bit those of generate() from the same EMA
    weights passed as a weights file;
25. ImageNet-64 through the CLI with Lightning's reading of
    accumulate_grad_batches: experiments/conf/imagenet.yaml with
    datamodule.batch_size=528 (3 microbatches of 176) on synthetic CHW
    .npy latents in the train/ + val/ layout (4 steps of 528, a validation
    batch of 528), one epoch, no preview, a checkpoint: exact launches (3 x
    (7 + 8) forward and backward per loop step, 7 + 8 per validation),
    finite losses; the loop's ms/step beside phase 23's bare step, the
    validation's seconds, the save's seconds and GB, the peak;
26. ImageNet-512 through the CLI on a latpack store: 1000 synthetic .npy
    latents packed by python -m tinyedm_tpu_torch.data.latpack (a gather
    from the store equal to the files bit for bit), then
    experiments/conf/imagenet512.yaml with datamodule.data_file on it,
    prefetch on, 2 epochs of 7 steps of 4 x 32, two EMA profiles,
    validation, the Heun-32 latent preview and a checkpoint every epoch:
    exact launches (7 + 8 forward and 7 + 8 backward per microbatch), the
    metrics rows, the checkpoints, the latest restored bit for bit; the
    loop's ms/step beside phase 12's bare step, samples/s, validation, the
    saves and the restore in seconds with the GB on disk, the peak; its
    previews decode through the VAE (phase 31);
27. post-hoc EMA: python -m tinyedm_tpu_torch.posthoc_ema over phase 26's
    two checkpoints (4 snapshots) at sigma_rel 0.13, which reproduces the
    latest step's tracked 0.13 tree within relative L2 1e-5 (a unit weight),
    with a one-profile config; then generate --ckpt_path --load_ema
    --num_classes 1000 --num_channels 4 at batch 32, Heun-32, equal bit for
    bit to generate() from the same tree as a weights file; the seconds and
    the GB written;
28. FID on CIFAR-10 with a seeded rehearsal InceptionV3 weight file
    (save_converted(..., pretrained=False) of a He-scaled random
    torchvision-layout state dict): the features on the card in fp32
    (TF32 off) against the CPU for 16 images (relative L2 <= 1e-4) and the
    img/s of feature extraction at batch 64 and 256; eval_fid stats on
    synthetic CIFAR-10 pickle batches and eval_fid score of 512 Heun-32
    samples (batch 128) of a seeded full-width checkpoint, with proxy and
    inception-unverified features and --kid: finite FID and KID, FID of
    the sample directory against itself at most 1e-9 of the covariance's
    trace; the default features refuse the rehearsal file
    (UnverifiedInceptionWeights); then cifar10.yaml for one epoch with
    FIDCallback on proxy features (256 samples), which logs fid. No number
    of this phase is an Inception FID.
29. the SD VAE (data/vae.py) at sd-vae-ft-ema's width with seeded random
    weights (83,653,863 parameters), written by the port's safetensors
    writer into a fake Hugging Face cache in a temporary $HF_HOME and as a
    .bin: load_vae by the default name (the cache) and from the .bin, both
    equal to the seeded state dict; the card against the CPU in fp32 (TF32
    off) on a 128x128 image and its 16x16 latent (mean, logvar and decode
    within relative L2 1e-4); img/s, achieved TFLOP/s against the fp32
    bound (operations counted on the meta device) and the peak memory of
    encode_moments of 16 images at 512x512 and of decode of 32 and of 80
    latents (the previews' batches), and the mid-block attentions' time
    alone; the decode of 32 in bf16 and with TF32 timed against fp32, with
    their relative L2 to it (no gate);
30. latent extraction: nvJPEG (csrc/nvjpeg_decode.cu, with libjpeg's
    chroma upsampling and YCbCr conversion in torch, and for the CMYK
    fixture nvJPEG's four stored components with PIL's CMYK conversion) on
    the committed JPEG fixtures against PIL's decodes (mean abs <= 1 level,
    max reported); a JPEG whose SOF says 2 components (a fixture edited in
    memory) refused naming the file; then an ImageFolder of PNGs
    written by the port (RGB, L, LA, RGBA, P; short sides from 260 to 1100,
    the BOX halvings from 1024) and the JPEG fixtures through python -m
    tinyedm_tpu_torch.data.extract_latents at --image-size 512, batch 8,
    flips on, the VAE found by name in the cache: the file count, names,
    labels and HWC float32 shapes; the output packed by the latpack CLI and
    read by PackedLatentsDataModule (a gather equal to the files); img/s
    with the seconds of decode, crop, encode and write;
31. the decoded preview: phase 26's run finds the VAE by its default name in
    the cache, so imagenet512.yaml's LatentsGenerateCallback (32 samples,
    Heun-32) decodes its previews: no "VAE unavailable" warning, each grid
    4 x 8 images of 512x512; one more preview on the trained state with its
    seconds, the decode's seconds, the peak memory beside the training state
    and the launches of rows 1-2 in its solve (63 forwards of 7 + 8).

32. reference (Lightning) checkpoints at full width: CIFAR-10 (35.62 M
    parameters, one EMA profile) and ImageNet-512 (272,949,794, two EMA
    profiles, the uncertainty head) with seeded weights, non-zero Adam
    moments and EMA trees, saved by the port, exported by python -m
    tinyedm_tpu_torch.utils.interop export (ImageNet-512's second profile)
    and imported back with --load_ema against the recipe's YAML: params,
    the exported EMA profile and the step bit-equal; generate --ckpt_path
    <imported> --load_ema (Heun-32 at the sampling batch, rows 1-2 launched
    63 times per layer) equal bit for bit to generate() from the original
    EMA tree as a weights file; a .ckpt of the reference layout made by this
    script (its own renames, the qkv channels reordered (heads, hd, 3) by
    its own reshape) imports to the same fp32 forward within relative L2
    1e-4; the .ckpt sizes, export and import seconds;
33. the model knobs: each recipe's train step (CIFAR-10 at 256,
    ImageNet-512 at 4 x 32, bf16) with remat off, "full" and "convs":
    ms/step over 3 steps after 1, peak GiB, step 0's loss bit-equal; one step's gradients in
    fp32 with cuDNN deterministic against remat off within relative L2
    1e-6 (or the spread of two remat-off runs, if larger) and the loss
    bit-equal; CIFAR-10 with mod_fp32=False (the bf16 island) against
    mod_fp32=True: the forward's and one step's gradients' relative L2,
    ms/step; CosineAttention(fused="on") at n 1024 and 961 (b 8, C 256, 4
    heads) against fused="off" in bf16 (output 1e-2, gradients 2e-2) and
    fp32 (1e-5), with rows 1-4's launches at those n, and rows 1-4's kernels
    timed at n 1024 beside plain, SDPA and the bound.
34. data parallelism and ZeRO-1 (tinyedm_tpu_torch/parallel): (a) python -m
    tinyedm_tpu_torch.train --multihost on cifar10.yaml in this process, over
    a one-rank NCCL group (RANK 0, WORLD_SIZE 1): 2 epochs of 10 steps of
    256, validation, the preview and a checkpoint each epoch, the rows 1-4
    launches as phase 24 counts them, exactly one all-reduce per step of
    the params' bytes (142.5 MB) and four scalars, one all-reduce of each
    validation's two fp64 sums, no all-gather; the second epoch's ms/step
    beside phase 24's loop and phase 9's bare step; the group destroyed by
    the CLI; (b) two spawned
    ranks sharing the card over gloo (host-staged), each on 128 of every
    global batch of 256, 3 steps of the CIFAR-10 recipe at full width in
    bf16, dropout 0, each image's sigma and noise a function of the image
    (the same rows draw the same on any rank): the param and EMA moves from
    the shared start and the Adam moments against one process at 256 from
    the same state within relative L2 5e-3 (DP_TOL), ZeRO-1 bit-equal to data
    parallel in params, moments and EMA on each rank, each rank's moment and
    EMA bytes, ms per step (gloo's, not NCCL's), the collectives and the rows
    1-4 launches per rank step (11 + 11, as phase 9 counts them per step);
    gloo's all-gather of CUDA tensors is checked first, and a refusal fails
    the phase; (c) the same over NCCL on
    two cards where the machine has two, else a line saying it did not run;
35. the CLIs over ranks: python -m torch.distributed.run --nproc_per_node 1
    -m tinyedm_tpu_torch.train --multihost on cifar10.yaml (NCCL) for a short
    epoch (5 steps of 256, a validation batch, a checkpoint); generate() on
    (b)'s two ranks, CIFAR-10 Heun-32, 64 samples at batch 64, against one
    process: the same 64 PNGs, each value within 1 level (cuDNN may pick
    another algorithm at the per-rank batch of 32), the values that differ
    counted.
36. tensor parallelism (tinyedm_tpu_torch/parallel/tensor.py): ranks
    sharing the card over gloo (host-staged: it checks the numbers and the
    collectives, not NCCL's speed). (a) CIFAR-10 at full width (35.62 M
    parameters) on a 1 x 2 grid, the four heads split two and two, 3 steps
    of the recipe with its dropout at a global batch of 32 (cut from 256:
    gloo stages every activation gather through the host) from seeded
    weights with gain_out 1, against one process at 32 from the same state
    and draws, in fp32 and in the recipe's bf16: in fp32 the param and EMA
    moves, mu and nu within relative L2 5e-3 (DP_TOL) and the losses within
    1e-3; in bf16 the first loss within 1e-3 and the rest within one
    process's own bf16 distance from fp32 (the comment at TP_GLOBAL says why
    bf16 cannot be held to 5e-3); the ranks' gathered states equal; each rank's param, moment and EMA bytes
    against one process's, the collectives by kind and group (no collective
    as large as the params), ms per rank step and the rows 1-4 launches,
    11 + 11 a step at 2 heads; (b) a 2 x 2 grid with ZeRO-1 (the moments
    sharded over both axes), one step of 2 x 16, draws injected, dropout 0,
    against one process at 32, the same gates; (c) ImageNet-512
    at full width through generate's CLI main with --model_parallel 2,
    Heun with num_steps 4 at batch 8, against one process: float samples
    within rtol = atol = 2e-2, the 8 PNGs written once (model rank 0), rows
    1-2 launched 7 + 8 a forward on each rank at 2 heads; (d) (a) over NCCL
    on two cards where the machine has two, else a line saying it did not
    run. Phases 3-4 hold rows 1-4 at these per-rank shapes (2 heads of 64 at
    batch 32, 2 of 144 and 192 at batch 8 forward and 32 backward).
37. the reference API on the card: the Protocols of
    tinyedm_tpu_torch.diffusion.protocols hold for objects built on the card
    (validate_learning's model: its Embedding, Denoiser; a DenoiserWrapper;
    the Diffuser and the three solvers); DenoiserWrapper around a
    parameter-free net on the card against the CPU in fp32 (rtol = atol =
    1e-6); mp_cat (NCHW channels, t 0.3) on the card against the CPU (fp32
    within 1e-6, bf16 equal); mp_dropout on the card: the keep fraction at
    rate 0.13 within 1e-3 of 0.87, every survivor exactly 1/0.87 rounded to
    fp32 and to bf16, the same mask from the same generator seed, x itself
    at rate 0;
38. validate_learning (python -m tinyedm_tpu_torch.validate_learning), run
    twice: the default (Heun-18) and --guided --autoguided
    --solver dpmpp2m (label dropout 0.15; DPM-Solver++(2M)-18; CFG at scale 2
    plain and on (0.1, 2.0); autoguidance at 1.5 and 2.0 by the EMA snapshot
    of step 300): 600 steps of 256 (the experiment's 1500 cut for time),
    each printing RESULT: PASS under the
    JAX experiment's thresholds, or the script fails; the per-class sims, ms
    a step, seconds; rows 2 and 4 (n 64, 2 heads of 48) launched exactly 2 +
    2 a train step and 2 a forward in every solve, with the EDM forwards
    counted by batch (the stacked 512 of CFG); then rows 2 and 4 against
    their plain versions at these shapes (forward at 256 and 512, backward
    at 256), with phases 3-4's limits and times. The two runs go at once,
    the guided one in a spawned process (each is bound by its host thread);
39. a short soak at the full CIFAR-10 recipe (python -m
    tinyedm_tpu_torch.soak: cifar10.yaml, lr 0.02, per-step schedule):
    --rampup 50 --steady 100 --decay 50 --ckpt_every 100 --stop_at 150,
    then --resume to 200 (resumed in the decay phase), in a temporary
    directory: RESULT: PASS in both calls (the lr on the reference formula
    at every logged step, both boundaries' steps +-2 among them, finite
    losses, the fresh run's last loss below its first), the checkpoints 100,
    150 and 200; samples/s of each call beside phase 9's bare step and phase
    24's loop;
40. the collective-audit CLI (python -m tinyedm_tpu_torch.collective_audit):
    --devices 2 over NCCL refused on a one-card machine; its in-process
    function on 2 ranks sharing the card over gloo (phase 36 (a)'s ranks,
    after their steps and (c)'s generate: one start-up), cifar10.yaml at full
    width on a 1 x 2 grid at batch 32 with --sampler: the ranks' inventories
    equal, the train step's summary equal to phase 36 (a)'s, no train-step
    collective as large as the params, the Heun-4 solve's model-group
    gathers and closing barrier, rows 1-4 launched 11 + 11 a step and 7 x 11
    a solve at 2 heads a rank; the train step's report (summary, payload,
    ring wire bytes, one row per collective), the sampler's totals;
41. weight_norm_cast (csrc/weight_norm.cu), the effective weights of every
    forward, and its backward kernel: the kernel against its plain version
    (the autograd composite's ops) at every weight shape of the CIFAR-10 and
    ImageNet-512 models, bf16 outputs at most one bf16 ulp apart and equal
    in at least 99.9% of their elements, fp32 within 2^-20 relative, plus
    rows of 20,000 values and more and a weight at an odd element offset;
    the backward kernel against the plain backward (autograd's gradient
    through the composite) at the same shapes from bf16 and fp32
    gradients, fp32 within 2^-20 of the largest value of its row, plus odd
    rows (45, 257, 769) and views at an odd element offset; the device
    times of each kernel and of the composite's kernels at five layer
    shapes (a profile over enough copies of the weight to pass the L2
    cache, read only where it holds the timed kernel, or the composite's
    reduction, for each call: up to five profiles, else the phase fails;
    the backwards through autograd, from a gradient in the layer's dtype),
    the host-bound times of back-to-back calls beside them, and the bound
    (bytes);
    a Heun-2 solve (3 forwards) of each model at its sampling batch, cuDNN
    deterministic, through the kernel's route (one launch a weight-normed
    layer a forward), the composite's and a control's (a kernel whose bf16
    cast truncates): each route twice gives the same samples, and the
    kernel's samples lie within WN_SOLVE_LIMIT relative L2 of the
    composite's, the control's beyond it; both solves' seconds;
    two CIFAR-10 train steps at 256 launching each kernel 2 x 115 times;
42. the flash kernels at DiT-XL/2's attention (the dit_xl2_512 recipe: a
    microbatch of 32, 1024 tokens, 16 heads of 72, the q, k, v views of one
    qkv tensor), bf16: the forward and backward against the plain versions
    (phase 5's limits), two backward calls on the same inputs bit for bit
    equal, their times on the 80 bucket that hd 72 takes (the backward's
    two passes apart, by the profiler: (a) dq and delta, (b) dk and dv),
    beside the plain versions, SDPA, the bound at hd 72 and, at hd 96 with
    the same b, n and heads, the 96 bucket's (the kernel hd 72 took before:
    the same k16 and n8 steps, 96 channels loaded where 72 are); then one
    make_train_step step of configs.build_training("dit_xl2_512") at that
    microbatch on seeded latents and labels: a finite loss and one flash
    forward and one flash backward a block at n = 1024: the model path's
    launches in phase 42's entries and phase 5's.
43. the flash kernels at FLUX.1-dev's joint attention (the flux_dev_1024
    recipe: a microbatch of 1, 512 text and 4096 image tokens, 24 heads of
    128, the q, k, v views of one qkv tensor), bf16: the forward and
    backward against the plain versions (phase 5's limits), two backward
    calls on the same inputs bit for bit equal, their times on the 128
    bucket (the backward's two passes apart, by the profiler) beside the
    plain versions, SDPA and the bound by edmbench/work.py's formulas
    (forward 4 b h n^2 hd operations and 4 b n C bf16 values, backward
    10 b h n^2 hd and 8 b n C); then one make_train_step step of
    configs.build_training("flux_dev_1024") at full width on seeded
    latents, text tokens and pooled vectors, the flash and QK-norm-RoPE
    counters zeroed just before it: a finite loss, and exactly depth +
    depth_single_blocks (9) flash calls and as many ops/rope.py
    qk_norm_rope calls each way at n = 4608: the model path's launches in
    phase 43's entries and phase 5's.

Phases 34 (a), (b) and 36 (a), (b) also print their last step's collectives
as the audit does (payload, ring wire bytes a rank, one row per collective),
36 (c) its totals. Each phase prints its seconds ([phase N] s).

Phases 18-22 run generate() twice, with fused attention and with
fused="off" (final samples within 2e-2 relative L2), and count the EDM
forwards by batch size (a wrapper of EDM.forward) beside the launches. The
forward kernel rows also hold the kernel at CFG's stacked batches (MNIST
256, ImageNet-512 64), the backward rows at MNIST's 128 and ImageNet-64's
176, and both at phase 36's per-rank shapes (2 heads). The rows of the
CIFAR-10, ImageNet-512 and ImageNet-64 shapes carry their launches per
loop step (phases 24, 26 and 25).

Then one JSON line of per-kernel numbers, the nvidia-smi name/power line,
and last {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

HEADS = 4
FUSED_FWD = "tinyedm_tpu/ops/fused_attention.py"
# (config, batch, n, head dim, TPU kernel) of the fused kernels on each path:
# the sampling batches (forward) and the training (micro)batches (backward)
# (the stacked batch of CFG: twice the sampling batch), keyed by the path
# whose run counts their launches
FWD_SHAPES = [
    ("cifar10", 128, 256, 64, f"{FUSED_FWD}:102"), ("cifar10", 128, 64, 64, f"{FUSED_FWD}:253"),
    ("imagenet512", 32, 256, 144, f"{FUSED_FWD}:102"), ("imagenet512", 32, 64, 192, f"{FUSED_FWD}:253"),
    ("mnist_cfg", 256, 196, 64, f"{FUSED_FWD}:102"), ("mnist_cfg", 256, 49, 128, f"{FUSED_FWD}:253"),
    ("imagenet512_cfg", 64, 256, 144, f"{FUSED_FWD}:102"), ("imagenet512_cfg", 64, 64, 192, f"{FUSED_FWD}:253"),
    # tensor parallelism (phase 36): a rank's 2 heads of the 4, at (a)'s
    # training batch and (c)'s sampling batch
    ("cifar10_tp", 32, 256, 64, f"{FUSED_FWD}:102"), ("cifar10_tp", 32, 64, 64, f"{FUSED_FWD}:253"),
    ("imagenet512_tp", 8, 256, 144, f"{FUSED_FWD}:102"), ("imagenet512_tp", 8, 64, 192, f"{FUSED_FWD}:253"),
]
BWD_SHAPES = [
    ("cifar10", 256, 256, 64, f"{FUSED_FWD}:144"), ("cifar10", 256, 64, 64, f"{FUSED_FWD}:305"),
    ("imagenet512", 32, 256, 144, f"{FUSED_FWD}:144"), ("imagenet512", 32, 64, 192, f"{FUSED_FWD}:305"),
    ("mnist", 128, 196, 64, f"{FUSED_FWD}:144"), ("mnist", 128, 49, 128, f"{FUSED_FWD}:305"),
    ("imagenet", 176, 256, 144, f"{FUSED_FWD}:144"), ("imagenet", 176, 64, 192, f"{FUSED_FWD}:305"),
    ("cifar10_tp", 32, 256, 64, f"{FUSED_FWD}:144"), ("cifar10_tp", 32, 64, 64, f"{FUSED_FWD}:305"),
    ("imagenet512_tp", 32, 256, 144, f"{FUSED_FWD}:144"), ("imagenet512_tp", 32, 64, 192, f"{FUSED_FWD}:305"),
]
# heads per kernel call where they are not HEADS: a rank's share at model size 2
SHAPE_HEADS = {"cifar10_tp": 2, "imagenet512_tp": 2}
# the run each FWD_SHAPES key's launches come from (phases 8, 11, 18, 21)
FWD_PATHS = {"cifar10": "cifar10 Heun-32 batch", "imagenet512": "imagenet512 Heun-32 batch",
             "mnist_cfg": "mnist CFG Heun-32 batch (stacked forwards)",
             "imagenet512_cfg": "imagenet512 CFG Heun-32 batch on (0.28, 2.9] (all its forwards at this n)",
             "cifar10_tp": "phase 36 (a): rank 0 of a 1 x 2 grid, 3 cifar10 train steps at 32",
             "imagenet512_tp": "phase 36 (c): rank 0 of a 1 x 2 grid, imagenet512 generate Heun-4 at 8"}
# flash shapes, 4 heads at batch 32: the ImageNet-512 channel plan at 32x32
# (C = 384) and 64x64 (C = 192), and 4 heads of 64 at n = 1024 and 4096
FLASH_SHAPES = [(1024, 96), (4096, 48), (1024, 64), (4096, 64)]
FLASH_BATCH = 32
FLASH_LAYERS = [(32, 384, 32), (8, 192, 64)]  # (batch, channels, side)
FLASH_REPLACES = {"fwd": "tinyedm_tpu/ops/attention.py:38", "bwd": "tinyedm_tpu/ops/attention.py:144"}
# phase 42: (batch, n, heads, hd) of DiT-XL/2's attention at one rank's
# microbatch of the dit_xl2_512 recipe
DIT_FLASH = (32, 1024, 16, 72)
DIT_STEP_PATH = "dit_xl2_512 train step, a microbatch of 32 (edmbench cell dit_xl2_512.train.b32)"
# phase 43: (batch, n, heads, hd) of FLUX.1-dev's joint attention at the
# flux_dev_1024 recipe's microbatch: FLUX_TXT text tokens and the 2 x 2
# packed tokens of (FLUX_LATENT_SIDE)^2 latents
FLUX_FLASH = (1, 4608, 24, 128)
FLUX_TXT, FLUX_LATENT_SIDE = 512, 128
FLUX_STEP_PATH = "flux_dev_1024 train step, a microbatch of 1 (edmbench cell flux_dev_1024.train.b1)"
TOL = {"bfloat16": 8e-3, "float32": 1e-5}
BWD_TOL = {"bfloat16": 1e-3, "float32": 1e-5}  # relative L2
# (batch, n, heads, hd): every head-dim bucket, ragged token counts (tails of
# every tile), n = 1, the ImageNet-512 head dims 144 and 192 at n = 33 and
# 65, and n = 300 at hd 256 (several key chunks per block)
ODD_SHAPES = [(3, 1, 1, 64), (4, 56, 4, 64), (2, 300, 2, 32), (2, 97, 2, 128), (2, 65, 1, 256), (2, 33, 3, 20),
              (2, 33, 2, 144), (2, 65, 2, 144), (2, 33, 2, 192), (2, 65, 2, 192), (2, 300, 1, 256)]
ODD_NOTE = "n = 1, 33, 56, 65, 97, 300; hd = 20, 32, 64, 128, 144, 192, 256"
# (batch, n, heads, hd) of the flash kernels: n = 1 (the CUDA-core route),
# ragged n past every tile, and every tensor-core head-dim bucket at n >= 2
# (32: hd 20; 48: hd 33 and 48; 64; 128; 192: hd 144 and 192; 256; 96 is
# FLASH_SHAPES')
FLASH_ODD = [(2, 1, 1, 256), (2, 1025, 2, 48), (1, 1100, 2, 64), (2, 2000, 1, 20),
             (1, 1100, 3, 144), (1, 1030, 1, 192), (3, 1024, 1, 33), (2, 1030, 2, 20),
             (2, 1030, 2, 144), (2, 1030, 2, 128), (1, 1030, 1, 256)]
KERNELS = ("cosine_attention_fwd", "cosine_attention_bwd", "flash_attention_fwd", "flash_attention_bwd",
           "attention_block_fwd", "attention_block_bwd", "winograd_fwd", "weight_norm")
LIBRARIES = ("nvjpeg_decode",)  # built beside the kernels; no TPU kernel's port (phase 30's JPEGs)
PTXAS_SHOWN = ("flash_attention_bwd", "attention_block_fwd", "attention_block_bwd",
               "weight_norm")  # ptxas -v in phase 2
WG_LAUNCH_REGS = 65536 // 384 // 8 * 8  # a thread's registers in a block of three warpgroups
# phase 41: the shapes whose times the kernel table keeps, and the limit
# of the Heun-2 samples of the kernel's route against the composite's,
# cuDNN deterministic. Read on an H100: each route twice 0; the kernel's
# 0.0081 (its bf16 weights one ulp from the composite's in 4 elements a
# million, its fp32 embedding weights within 4e-7 relative in 16% of
# theirs, since a row's sum of squares is added in another order: the bf16
# roundings downstream carry that to every sample); a control whose bf16
# cast truncates, 0.0156 and 0.0194. The limit lies between them, near
# their geometric mean.
# The backward kernel's limit: 2^-20 of its row's largest value (the two
# fp32 sums in another order than the composite's).
WN_TIMED = [("cifar10", (256, 256, 3, 3)), ("cifar10", (768, 256, 1, 1)), ("imagenet512", (768, 768, 3, 3)),
            ("imagenet512", (768, 1536, 3, 3)), ("imagenet512", (768, 1000))]
WN_SOLVE_LIMIT = 0.0115
# the whole-block kernels at the CIFAR-10 attention widths: (batch, n) per
# direction, the sampling batch forward and the training batch backward
BLOCK_C = 256
BLOCK_SHAPES = [("fwd", 128, 256), ("fwd", 128, 64), ("bwd", 256, 256), ("bwd", 256, 64)]
BLOCK_REPLACES = {"fwd": f"{FUSED_FWD}:429", "bwd": f"{FUSED_FWD}:461"}
# odd block shapes (batch, n, heads, C): head dims 64, 32, 64, 192, 192, 20
# and 96 (C = 20: rows off 16 bytes, the bf16 GEMMs' element loads). The
# bf16 GEMMs take 64-row tiles where K <= 256, else 128-row ones: C = 288
# runs the forward's on 128-row tiles with ragged edges (M = 600, N = 864)
BLOCK_ODD = [(2, 1, 1, 64), (3, 49, 3, 96), (2, 300, 4, 256), (2, 64, 4, 768), (2, 300, 1, 192),
             (2, 50, 1, 20), (2, 300, 3, 288)]
BLOCK_LAYERS = [(8, 256, 16), (8, 768, 8)]  # (batch, channels, side): compile_check's shapes
# (batch, side, Ci, Co) of the CIFAR-10 model's 3x3 convs, and odd shapes
# (batch, H, W, Ci, Co)
WINO_SHAPES = [(128, 32, 256, 256), (128, 16, 256, 256), (128, 8, 256, 256), (128, 32, 4, 256)]
WINO_ODD = [(2, 2, 2, 24, 3), (2, 6, 6, 3, 20), (1, 4, 8, 20, 24), (3, 6, 4, 24, 20),
            (3, 10, 14, 40, 72)]
WINO_REPLACES = "tinyedm_tpu/ops/winograd.py:73"
LATENT_MEAN = (5.81, 3.25, 0.12, -2.15)  # experiments/conf/imagenet512.yaml:74-75
LATENT_STD = (4.17, 4.62, 3.71, 3.28)
# per config: sampling batch, image side, classes, kernel calls of one
# forward by token count, the PNG color type and the PNG mapping (mean,
# std) of its samples, warm-up and timed train steps, the lr schedule count
# at which the full lr applies; "microbatch": the step batch is the
# recipe's accumulation count times this (Lightning's
# accumulate_grad_batches), else the recipe's batch is the step batch
PATHS = {
    "cifar10": dict(batch=128, side=32, classes=None, calls={256: 5, 64: 6}, color=2, denorm={},
                    warmup=3, timed=10, sched=200),
    "imagenet512": dict(batch=32, side=64, classes=1000, calls={256: 7, 64: 8}, color=6,
                        denorm=dict(mean=LATENT_MEAN, std=LATENT_STD), warmup=2, timed=3, sched=10000),
    # 28x28x1 digits: attention at 14x14 (4 heads of 64) and 7x7 (4 of 128);
    # PNGs map the data range [-1, 1] onto [0, 1]
    "mnist": dict(batch=128, side=28, classes=10, calls={196: 7, 49: 8}, color=0,
                  denorm=dict(mean=(0.5,), std=(0.25,)), warmup=2, timed=3, sched=500),
    # ImageNet-64 latents (experiments/conf/imagenet.yaml): 3 x 176 per step
    "imagenet": dict(batch=32, side=64, classes=1000, calls={256: 7, 64: 8}, microbatch=176,
                     warmup=1, timed=2, sched=10000),
}
# the run loop (phase 24): synthetic CIFAR-10 pickle batches, 5 x 1024 train
# images (20 steps of 256 per epoch) and 1000 test images (a tail of 232)
LOOP_TRAIN_BATCH, LOOP_TEST = 1024, 1000
LOOP_EPOCHS, LOOP_RESUMED_EPOCHS = 2, 3
LOOP_PREVIEW_FORWARDS = 2 * 18 - 1  # the recipe's Heun-18 preview
CHURN = dict(s_churn=40.0, s_min=0.05, s_max=50.0, s_noise=1.003)  # EDM's ImageNet-64 settings
CFG_INTERVAL = (0.28, 2.9)  # 14 of Heun-32's 63 half-steps lie in it
# ImageNet-64 through the CLI (phase 25): Lightning's reading of
# imagenet.yaml's accumulate_grad_batches (3 microbatches of 176), on
# synthetic latents in the train/ + val/ layout: 4 steps, one val batch
IN64_BATCH, IN64_STEPS, IN64_VAL = 3 * 176, 4, 3 * 176
# ImageNet-512 through the CLI (phase 26): 1000 synthetic latents in one
# latpack store (990 train: 7 steps of 4 x 32 per epoch; 10 val)
IN512_SAMPLES, IN512_EPOCHS = 1000, 2
IN512_PREVIEW = (32, 2 * 32 - 1)  # imagenet512.yaml's preview: 8 classes x 4 latents, Heun-32
POSTHOC_TARGET = 0.13  # one of the tracked profiles: exactly representable at the latest step
# FID on CIFAR-10 (phase 28)
FID_SAMPLES, FID_BATCH, FID_KID_SUBSETS = 512, 128, 10
FID_CALLBACK_SAMPLES = 256
INCEPTION_BATCHES = (64, 256)  # the JAX feature function's sub-batch, and a larger one
# the latent pipeline (phases 29-31): the sd-vae-ft-ema architecture with
# seeded random weights; encode at 512 (batch 16), decode at the previews'
# batches (imagenet512.yaml's 32, imagenet.yaml's 80), the card against the
# CPU at 128x128 (Inception's gate)
VAE_SEED, VAE_PARAMS = 0, 83_653_863
VAE_ENCODE, VAE_DECODES, VAE_CPU_SIDE, VAE_TOL = (16, 512), (32, 80), 128, 1e-4
# extraction (phase 30): an ImageFolder of PNGs written by the port (class,
# name, mode, height, width; short sides >= 1024 take the BOX halvings) and
# the committed JPEG fixtures, through the CLI at 512 in batches of 8
JPEG_FIXTURES = ROOT / "tests" / "torch_fixtures"
JPEG_READ = ("rgb420", "rgb422", "rgb444", "grey", "progressive", "cmyk")
JPEG_MEAN_TOL = 1.0  # levels: nvJPEG's IDCT against libjpeg's
EXTRACT_SIZE, EXTRACT_BATCH = 512, 8
EXTRACT_PNGS = [("cat", "rgb_box", "RGB", 1100, 1300), ("cat", "grey", "L", 600, 700),
                ("cat", "rgba", "RGBA", 520, 780), ("cat", "palette_box", "P", 1040, 1200),
                ("cat", "rgb_wide", "RGB", 513, 1500), ("dog", "la", "LA", 700, 530),
                ("dog", "rgb", "RGB", 530, 610), ("dog", "grey_box", "L", 1200, 1024),
                ("dog", "rgb_small", "RGB", 300, 260)]
EXTRACT_JPEGS = [("cat", "rgb420"), ("cat", "grey"), ("dog", "rgb444"), ("dog", "rgb422"), ("dog", "progressive"),
                 ("dog", "cmyk")]


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time per call of ``iters``
    back-to-back calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


class Laps:
    """Each phase's seconds: ``lap(name)`` prints ``[phase name] s`` for the
    time since the last lap (or since the clock was made) and keeps it."""

    def __init__(self):
        self.last = time.perf_counter()
        self.table: list[tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.table.append((name, now - self.last))
        self.last = now
        print(f"[phase {name}] {self.table[-1][1]:.1f} s", flush=True)


def rel_l2(a, b) -> float:
    """Relative L2 distance; 0 for two zero tensors (dq and dk at n = 1)."""
    a, b = a.double(), b.double()
    ref = float(b.norm())
    if ref == 0.0:
        return 0.0 if float(a.norm()) == 0.0 else float("inf")
    return float((a - b).norm()) / ref


def _fmt(counts: dict) -> str:
    return "{" + ", ".join(f"{d} n={n}: {c}" for (d, n), c in sorted(counts.items())) + "}"


def phase_environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 environment] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tinyedm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sources = KERNELS + LIBRARIES
    with ThreadPoolExecutor(len(sources)) as pool:  # nvcc runs outside the GIL
        paths = list(pool.map(lambda k: _build.build(k, ptxas_verbose=True), sources))
    for name, path in zip(sources, paths):
        _build.load_library(name)
        print(f"[2 build] {name}.cu -> {path.relative_to(ROOT)}", flush=True)
    print(f"[2 build] {len(KERNELS)} kernels and {', '.join(LIBRARIES)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in PTXAS_SHOWN:  # empty where an earlier run built the library
        for line in _build.ptxas_log.get(name, "").splitlines():
            if re.search(r"Compiling entry function|spill stores|Used \d+ registers", line):
                print(f"[2 build] ptxas {name}: {line.strip()}", flush=True)
    # the flash backward's warpgroup kernels move registers from their
    # producers to their consumers (setmaxnreg): the launch has to give every
    # thread of the 384 its share of the whole register file, or a consumer's
    # request would wait forever
    log = _build.ptxas_log.get("flash_attention_bwd", "")
    short = {entry: n for entry, n in _build.ptxas_registers(log).items()
             if "_wg_kernel" in entry and n != WG_LAUNCH_REGS}
    if short or "setmaxnreg ignored" in log:
        fail(f"flash_attention_bwd's warpgroup kernels launch with {short or 'setmaxnreg ignored'}, "
             f"not {WG_LAUNCH_REGS} registers a thread")


def _qkv(b, n, heads, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3 * heads * hd), generator=g, device="cuda") * 0.7
    return x.to(dtype)


def _cotangent(b, n, heads, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return (torch.randn((b, n, heads * hd), generator=g, device="cuda") * 0.5).to(dtype)


def _bound(nbytes: int, flops: int, dtype_name: str, fp32_flops: int = 0) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it.
    ``flops`` are products in ``dtype_name``; ``fp32_flops`` other fp32
    operations (Winograd's transforms), on the CUDA cores beside bf16
    products on the tensor cores, on the same cores as fp32 products."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    if dtype_name == "float32":
        t_ops = (flops + fp32_flops) / PEAK_FLOPS["float32"]
    else:
        t_ops = max(flops / PEAK_FLOPS[dtype_name], fp32_flops / PEAK_FLOPS["float32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check(out, ref, dtype_name: str, what: str) -> float:
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite kernel output")
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype_name]
    if dtype_name == "float32":
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol, msg=lambda m: f"{what}: {m}")
    elif err > tol:
        fail(f"{what}: max abs {err} > {tol}")
    return err


def _entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": f"tinyedm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def _fwd_shape(tag: str, config: str, b: int, n: int, hd: int, heads: int, replaces: str) -> dict:
    """The forward kernel against its plain version at one path's shape, bf16
    and fp32, timed beside the plain version, SDPA and the bound; returns the
    bf16 entry of the kernel line."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    c = heads * hd
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        qkv = _qkv(b, n, heads, hd, dtype, seed=n + hd)
        out = fa.cosine_attention_qkv_cuda(qkv, heads)
        torch.cuda.synchronize()
        ref = fa.cosine_attention_qkv_plain(qkv, heads)
        err = _check(out, ref, name, f"{config} n={n} hd={hd} {name}")
        ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, heads))
        plain_ms = time_ms(lambda: fa.cosine_attention_qkv_plain(qkv, heads), iters=5)
        x = pixel_norm(qkv.reshape(b, n, 3, heads, hd), dim=-1)
        q, k, v = (t.transpose(1, 2).contiguous() for t in x.unbind(2))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
        flops = 4 * b * heads * n * n * hd
        bound_ms, bound_by = _bound(nbytes, flops, name)
        print(f"[{tag}] cosine_attention_fwd {config} b={b} n={n} C={c} "
              f"heads={heads} {name}: max_abs {err:.3g} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        if dtype == torch.bfloat16:  # the main path's type
            entry = _entry(
                f"cosine_attention_fwd[{config} n={n} hd={hd}" + (f" heads={heads}]" if heads != HEADS else "]"),
                "cosine_attention_fwd.cu", replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms,
                config=config, n=n)
    return entry


def phase_kernel_vs_plain() -> list[dict]:
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    entries = [_fwd_shape("3 fwd kernel vs plain", config, b, n, hd, SHAPE_HEADS.get(config, HEADS), replaces)
               for config, b, n, hd, replaces in FWD_SHAPES]
    # every head-dim bucket, ragged token counts (tails of both tiles), n=1
    for b, n, heads, hd in ODD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, heads, hd, dtype, seed=b * n + hd)
            out = fa.cosine_attention_qkv_cuda(qkv, heads)
            torch.cuda.synchronize()
            _check(out, fa.cosine_attention_qkv_plain(qkv, heads), name, f"b={b} n={n} hd={hd} {name}")
    print(f"[3 fwd kernel vs plain] odd shapes ({ODD_NOTE}): ok", flush=True)
    return entries


def _check_bwd(out, ref, dtype_name: str, what: str) -> tuple[float, float]:
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite backward kernel output")
    err = float((out.float() - ref.float()).abs().max())
    rel = rel_l2(out, ref)
    if not rel <= BWD_TOL[dtype_name]:
        fail(f"{what}: backward relative L2 {rel} > {BWD_TOL[dtype_name]}")
    return err, rel


def _sdpa_bwd_ms(q, k, v, g) -> tuple[float, float]:
    """SDPA's backward time, as its forward plus backward through autograd
    minus its forward alone (both with grad enabled), on (b, heads, n, hd)
    tensors; and the two times it is the difference of."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5, reps=3)
        both_ms = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, v), (q, k, v), g), iters=5, reps=3)
    return both_ms - fwd_ms, both_ms, fwd_ms


def _bwd_shape(tag: str, config: str, b: int, n: int, hd: int, heads: int, replaces: str) -> dict:
    """The backward kernel against its plain version at one training path's
    shape, as ``_fwd_shape``; library time: scaled_dot_product_attention's
    backward on the pixel-normed q, k, v."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    entry = None
    c = heads * hd
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        qkv = _qkv(b, n, heads, hd, dtype, seed=n + hd)
        g = _cotangent(b, n, heads, hd, dtype, seed=n + hd)
        o = fa.cosine_attention_qkv_cuda(qkv, heads)
        torch.cuda.synchronize()
        fwd_err = _check(o, fa.cosine_attention_qkv_plain(qkv, heads), name,
                         f"fwd {config} b={b} n={n} {name}")
        out = fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, heads)
        torch.cuda.synchronize()
        ref = fa.cosine_attention_qkv_bwd_plain(qkv, g, o, heads)
        err, rel = _check_bwd(out, ref, name, f"bwd {config} n={n} {name}")
        del ref
        ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, heads), iters=10)
        plain_ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_plain(qkv, g, o, heads), iters=3)
        x = pixel_norm(qkv.reshape(b, n, 3, heads, hd), dim=-1)
        q, k, v = (t.transpose(1, 2).contiguous() for t in x.unbind(2))
        gh = g.reshape(b, n, heads, hd).transpose(1, 2).contiguous()
        library_ms, both_ms, sdpa_fwd_ms = _sdpa_bwd_ms(q, k, v, gh)
        nbytes = 8 * b * n * c * qkv.element_size()
        flops = 10 * b * heads * n * n * hd
        bound_ms, bound_by = _bound(nbytes, flops, name)
        print(f"[{tag}] cosine_attention_bwd {config} b={b} n={n} C={c} "
              f"heads={heads} {name}: max_abs {err:.3g} rel_l2 {rel:.3g} | kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa bwd {library_ms:.4f} ms ({both_ms:.4f} - "
              f"{sdpa_fwd_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); forward kernel vs plain max_abs {fwd_err:.3g}", flush=True)
        if dtype == torch.bfloat16:  # the main path's type
            fwd_kernel_ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, heads))
            fwd_bound, fwd_by = _bound(4 * b * n * c * qkv.element_size(),
                                       4 * b * heads * n * n * hd, name)
            print(f"[{tag}] (the forward kernel at this batch: {fwd_kernel_ms:.4f} ms, "
                  f"bound {fwd_bound:.4f} ms by {fwd_by})", flush=True)
            entry = _entry(
                f"cosine_attention_bwd[{config} n={n} hd={hd}" + (f" heads={heads}]" if heads != HEADS else "]"),
                "cosine_attention_bwd.cu", replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms,
                config=config, n=n)
    return entry


def phase_bwd_kernel_vs_plain() -> list[dict]:
    """The backward kernel against its plain version at the training paths'
    shapes (``_bwd_shape``), and at the odd shapes."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    entries = [_bwd_shape("4 bwd kernel vs plain", config, b, n, hd, SHAPE_HEADS.get(config, HEADS), replaces)
               for config, b, n, hd, replaces in BWD_SHAPES]
    for b, n, heads, hd in ODD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, heads, hd, dtype, seed=b * n + hd)
            g = _cotangent(b, n, heads, hd, dtype, seed=b * n + hd)
            o = fa.cosine_attention_qkv_cuda(qkv, heads)
            out = fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, heads)
            torch.cuda.synchronize()
            _check_bwd(out, fa.cosine_attention_qkv_bwd_plain(qkv, g, o, heads), name,
                       f"bwd b={b} n={n} hd={hd} {name}")
    print(f"[4 bwd kernel vs plain] odd shapes ({ODD_NOTE}): ok", flush=True)
    return entries


def _flash_inputs(b, n, heads, hd, dtype, seed):
    """q, k, v as the model hands them over (the views of one (b, n, 3,
    heads, hd) tensor) and a cotangent g."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3, heads, hd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
    return (*x.unbind(2), g)


def _check_flash(q, k, v, g, name: str, what: str) -> tuple[float, float, float]:
    """Both flash kernels against the plain versions: (forward max abs,
    backward max abs, worst backward relative L2 over dq, dk, dv)."""
    import torch

    from tinyedm_tpu_torch.ops import attention as fl

    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    fwd_err = _check(out, fl.flash_attention_plain(q, k, v), name, f"flash fwd {what}")
    grads = fl.flash_attention_bwd_cuda(q, k, v, g, stats)
    torch.cuda.synchronize()
    errs = [_check_bwd(d, r, name, f"flash bwd {what} {label}")
            for d, r, label in zip(grads, fl.flash_attention_bwd_plain(q, k, v, g), ("dq", "dk", "dv"))]
    return fwd_err, max(e for e, _ in errs), max(r for _, r in errs)


def phase_flash_kernels() -> list[dict]:
    """The flash kernels against their plain versions; times at batch 32 of
    the kernels, the plain versions and SDPA on the same q, k, v."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import attention as fl

    entries = []
    for n, hd in FLASH_SHAPES:
        check_b = FLASH_BATCH if n <= 1024 else 8
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, g = _flash_inputs(check_b, n, HEADS, hd, dtype, seed=n + hd)
            fwd_err, bwd_err, bwd_rel = _check_flash(q, k, v, g, name, f"b={check_b} n={n} hd={hd} {name}")
            print(f"[5 flash vs plain] b={check_b} n={n} heads={HEADS} hd={hd} {name}: forward max_abs "
                  f"{fwd_err:.3g}, backward max_abs {bwd_err:.3g} worst rel_l2 {bwd_rel:.3g}", flush=True)
            if dtype != torch.bfloat16:  # times in the main path's type
                continue
            b = FLASH_BATCH
            if check_b != b:
                del q, k, v, g
                torch.cuda.empty_cache()
                q, k, v, g = _flash_inputs(b, n, HEADS, hd, dtype, seed=n + hd)
            out, stats = fl.flash_attention_fwd_cuda(q, k, v)
            heavy = n * n * hd >= 4096 * 4096 * 48
            iters, reps = (1, 3) if heavy else (3, 3)
            fwd_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v), iters=iters, reps=reps)
            fwd_plain = time_ms(lambda: fl.flash_attention_plain(q, k, v), iters=1, reps=3)
            bwd_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats), iters=iters, reps=reps)
            bwd_plain = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, g), iters=1, reps=3)
            qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
            fwd_sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5, reps=3)
            bwd_sdpa, _, _ = _sdpa_bwd_ms(qh, kh, vh, gh)
            del qh, kh, vh, gh
            io = b * n * HEADS * hd * q.element_size()
            fwd_bound, fwd_by = _bound(4 * io, 4 * b * HEADS * n * n * hd, name)
            bwd_bound, bwd_by = _bound(7 * io, 10 * b * HEADS * n * n * hd, name)
            print(f"[5 flash vs plain] b={b} n={n} heads={HEADS} hd={hd} {name}: forward kernel "
                  f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, sdpa {fwd_sdpa:.4f} ms, bound "
                  f"{fwd_bound:.4f} ms ({fwd_by}); backward kernel {bwd_ms:.4f} ms, plain "
                  f"{bwd_plain:.4f} ms, sdpa bwd {bwd_sdpa:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by})",
                  flush=True)
            if (n, hd) in ((1024, 96), (4096, 48)):  # the ImageNet-512 widths
                for d, err, ms, plain_ms, bound_ms, bound_by, lib_ms in (
                    ("fwd", fwd_err, fwd_ms, fwd_plain, fwd_bound, fwd_by, fwd_sdpa),
                    ("bwd", bwd_err, bwd_ms, bwd_plain, bwd_bound, bwd_by, bwd_sdpa),
                ):
                    entries.append(_entry(
                        f"flash_attention_{d}[b={b} n={n} hd={hd}]", f"flash_attention_{d}.cu",
                        FLASH_REPLACES[d], err, ms, plain_ms, bound_ms, bound_by, lib_ms, n=n))
            del q, k, v, g, out, stats
            torch.cuda.empty_cache()
    for b, n, heads, hd in FLASH_ODD:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, g = _flash_inputs(b, n, heads, hd, dtype, seed=b * n + hd)
            for layout, (qq, kk, vv) in (("views", (q, k, v)),
                                         ("contiguous", (t.contiguous() for t in (q, k, v)))):
                _check_flash(qq, kk, vv, g, name, f"b={b} n={n} heads={heads} hd={hd} {name} {layout}")
    print(f"[5 flash vs plain] odd shapes (n = 1, 1024, 1025, 1030, 1100, 2000; hd = 20, 33, 48, 64, "
          f"128, 144, 192, 256; qkv views and contiguous): ok", flush=True)
    return entries


def _dit_step_calls(b: int) -> dict:
    """The flash calls of one make_train_step step of the dit_xl2_512
    recipe at its microbatch ``b``, on seeded weights, latents and labels."""
    import torch

    from tinyedm_tpu_torch.configs import CONFIGS, build_training
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    model, diffuser, opt_cfg, ema_cfg, batch, _ = build_training("dit_xl2_512", "cuda", seed=0)
    if batch // opt_cfg.accum_steps != b:
        fail(f"the dit_xl2_512 recipe's microbatch is {batch // opt_cfg.accum_steps}, phase 42 times {b}")
    opt_cfg = dataclasses.replace(opt_cfg, accum_steps=1)
    cfg = CONFIGS["dit_xl2_512"]
    d = cfg["denoiser"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.5 * torch.randn((b, d["in_channels"], d["input_size"], d["input_size"]), generator=gen, device="cuda")
    y = torch.randint(0, cfg["embedding"]["num_classes"], (b,), generator=gen, device="cuda")
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    torch.cuda.synchronize()
    _clear_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, (x, y), gen, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls, loss = _flash_calls(), float(metrics["train_loss"])
    n = (d["input_size"] // d["patch_size"]) ** 2
    expected = {("flash_fwd", n): d["depth"], ("flash_bwd", n): d["depth"]}
    print(f"[42 flash at DiT-XL/2] one dit_xl2_512 train step at {b}: loss {loss:.4f}, {seconds:.2f} s "
          f"(the first), flash calls {_fmt(calls)}", flush=True)
    if calls != expected or not math.isfinite(loss):
        fail(f"a dit_xl2_512 train step made flash calls {calls} (expected {expected}), loss {loss}")
    del model, state, step, metrics, x, y
    torch.cuda.empty_cache()
    return calls


def _kernel_ms(fn, keys: tuple[str, ...], calls: int = 5) -> list[float]:
    """Device ms a call of ``fn`` in the kernels whose names hold each of
    ``keys``, from a profile of ``calls`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ns = [0] * len(keys)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            for i, key in enumerate(keys):
                if key in e.name():
                    ns[i] += e.duration_ns()
    return [t / 1e6 / calls for t in ns]


def phase_flash_dit() -> tuple[list[dict], dict]:
    """42: the flash kernels at DiT-XL/2's shape (hd 72, the 80 bucket)
    against the plain versions, timed beside the 96 bucket at hd 96, and
    the flash calls of a dit_xl2_512 train step (``_dit_step_calls``):
    returns the kernels' entries and those calls."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import attention as fl

    b, n, heads, hd = DIT_FLASH
    name = "bfloat16"
    q, k, v, g = _flash_inputs(b, n, heads, hd, torch.bfloat16, seed=hd)
    what = f"b={b} n={n} heads={heads} hd={hd} {name}"
    fwd_err, bwd_err, bwd_rel = _check_flash(q, k, v, g, name, what)
    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    twice = [fl.flash_attention_bwd_cuda(q, k, v, g, stats) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(*twice)):
        fail(f"flash bwd {what}: two calls on the same inputs differ")
    del twice
    fwd_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v), iters=3, reps=3)
    bwd_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats), iters=3, reps=3)
    pass_a, pass_b = _kernel_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats),
                                ("flash_bwd_dq_", "flash_bwd_dkv_"))
    fwd_plain = time_ms(lambda: fl.flash_attention_plain(q, k, v), iters=1, reps=3)
    bwd_plain = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, g), iters=1, reps=3)
    qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    fwd_sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5, reps=3)
    bwd_sdpa, _, _ = _sdpa_bwd_ms(qh, kh, vh, gh)
    del qh, kh, vh, gh, out, stats, q, k, v, g
    io = b * n * heads * hd * 2
    fwd_bound, fwd_by = _bound(4 * io, 4 * b * heads * n * n * hd, name)
    bwd_bound, bwd_by = _bound(7 * io, 10 * b * heads * n * n * hd, name)
    q, k, v, g = _flash_inputs(b, n, heads, 96, torch.bfloat16, seed=96)
    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    fwd96 = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v), iters=3, reps=3)
    bwd96 = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats), iters=3, reps=3)
    del q, k, v, g, out, stats
    torch.cuda.empty_cache()
    print(f"[42 flash at DiT-XL/2] {what} (bucket 80): forward max_abs {fwd_err:.3g}, kernel {fwd_ms:.4f} ms "
          f"(bucket 96 at hd 96: {fwd96:.4f} ms), plain {fwd_plain:.4f} ms, sdpa {fwd_sdpa:.4f} ms, bound "
          f"{fwd_bound:.4f} ms ({fwd_by}); backward max_abs {bwd_err:.3g} worst rel_l2 {bwd_rel:.3g}, two calls "
          f"bit-identical, kernels {bwd_ms:.4f} ms (profiled: pass (a) {pass_a:.4f} ms, pass (b) {pass_b:.4f} ms; "
          f"bucket 96: {bwd96:.4f} ms), plain {bwd_plain:.4f} ms, sdpa bwd {bwd_sdpa:.4f} ms, "
          f"bound {bwd_bound:.4f} ms ({bwd_by})", flush=True)
    calls = _dit_step_calls(b)
    entries = []
    for d, err, ms, plain_ms, bound_ms, bound_by, lib_ms, ms96, extra in (
        ("fwd", fwd_err, fwd_ms, fwd_plain, fwd_bound, fwd_by, fwd_sdpa, fwd96, {}),
        ("bwd", bwd_err, bwd_ms, bwd_plain, bwd_bound, bwd_by, bwd_sdpa, bwd96,
         {"pass_a_ms": pass_a, "pass_b_ms": pass_b}),
    ):
        entries.append(_entry(
            f"flash_attention_{d}[b={b} n={n} heads={heads} hd={hd}]", f"flash_attention_{d}.cu", FLASH_REPLACES[d],
            err, ms, plain_ms, bound_ms, bound_by, lib_ms, bucket96_ms=ms96, launches=calls[f"flash_{d}", n],
            launches_per_train_step=calls[f"flash_{d}", n], path=DIT_STEP_PATH, **extra))
    return entries, calls



def _flux_step_calls(b: int) -> tuple[dict, dict]:
    """The flash calls and the QK-norm-RoPE calls of one make_train_step
    step of the flux_dev_1024 recipe at its microbatch ``b`` (a forward and
    a backward at full width), on seeded weights, latents, text tokens and
    pooled vectors, the counters zeroed just before it."""
    import torch

    from tinyedm_tpu_torch.configs import CONFIGS, build_training
    from tinyedm_tpu_torch.diffusion.protocols import TextConditioning
    from tinyedm_tpu_torch.ops import rope
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    model, diffuser, opt_cfg, ema_cfg, batch, _ = build_training("flux_dev_1024", "cuda", seed=0)
    if batch // opt_cfg.accum_steps != b:
        fail(f"the flux_dev_1024 recipe's microbatch is {batch // opt_cfg.accum_steps}, phase 43 runs {b}")
    opt_cfg = dataclasses.replace(opt_cfg, accum_steps=1)
    d, e = CONFIGS["flux_dev_1024"]["denoiser"], CONFIGS["flux_dev_1024"]["embedding"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    side = FLUX_LATENT_SIDE
    x = torch.randn((b, d["in_channels"] // 4, side, side), generator=gen, device="cuda")
    cond = TextConditioning(torch.randn((b, FLUX_TXT, d["context_in_dim"]), generator=gen, device="cuda"),
                            torch.randn((b, e["vec_in_dim"]), generator=gen, device="cuda"),
                            torch.ones((b,), device="cuda"))
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    torch.cuda.synchronize()
    _clear_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, (x, cond), gen, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls, loss = _flash_calls(), float(metrics["train_loss"])
    rope_calls = {k: v for k, v in rope.call_counts.items() if v}
    n, blocks = FLUX_TXT + (side // 2) ** 2, d["depth"] + d["depth_single_blocks"]
    expected = {("flash_fwd", n): blocks, ("flash_bwd", n): blocks}
    expected_rope = {("qk_norm_rope", n): blocks, ("qk_norm_rope_bwd", n): blocks}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[43 flash at FLUX.1-dev] one flux_dev_1024 train step at {b} ({d['depth']} double + "
          f"{d['depth_single_blocks']} single blocks): loss {loss:.4f}, {seconds:.2f} s (the first), flash calls "
          f"{_fmt(calls)}, qk_norm_rope calls {_fmt(rope_calls)}, allocator peak so far {peak:.2f} GiB", flush=True)
    if calls != expected or rope_calls != expected_rope or not math.isfinite(loss):
        fail(f"a flux_dev_1024 train step made flash calls {calls} (expected {expected}), qk_norm_rope calls "
             f"{rope_calls} (expected {expected_rope}), loss {loss}")
    del model, state, step, metrics, x, cond
    torch.cuda.empty_cache()
    return calls, rope_calls


def phase_flash_flux() -> tuple[list[dict], dict]:
    """43: the flash kernels at FLUX.1-dev's joint attention (hd 128, the
    128 bucket, n 4608) against the plain versions, timed, and the flash and
    QK-norm-RoPE calls of a flux_dev_1024 train step (``_flux_step_calls``):
    returns the kernels' entries and the flash calls."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import attention as fl

    b, n, heads, hd = FLUX_FLASH
    if n != FLUX_TXT + (FLUX_LATENT_SIDE // 2) ** 2:
        fail(f"FLUX_FLASH's n {n} is not {FLUX_TXT} text tokens and the packed {FLUX_LATENT_SIDE}^2 latents")
    name = "bfloat16"
    q, k, v, g = _flash_inputs(b, n, heads, hd, torch.bfloat16, seed=hd + 1)
    what = f"b={b} n={n} heads={heads} hd={hd} {name}"
    fwd_err, bwd_err, bwd_rel = _check_flash(q, k, v, g, name, what)
    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    twice = [fl.flash_attention_bwd_cuda(q, k, v, g, stats) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(*twice)):
        fail(f"flash bwd {what}: two calls on the same inputs differ")
    del twice
    fwd_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v), iters=3, reps=3)
    bwd_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats), iters=3, reps=3)
    pass_a, pass_b = _kernel_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats),
                                ("flash_bwd_dq_", "flash_bwd_dkv_"))
    fwd_plain = time_ms(lambda: fl.flash_attention_plain(q, k, v), iters=1, reps=3)
    bwd_plain = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, g), iters=1, reps=3)
    qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    fwd_sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5, reps=3)
    bwd_sdpa, _, _ = _sdpa_bwd_ms(qh, kh, vh, gh)
    del qh, kh, vh, gh, out, stats, q, k, v, g
    torch.cuda.empty_cache()
    io = b * n * heads * hd * 2  # one of q, k, v, o or g in bf16
    fwd_bound, fwd_by = _bound(4 * io, 4 * b * heads * n * n * hd, name)
    bwd_bound, bwd_by = _bound(8 * io, 10 * b * heads * n * n * hd, name)
    print(f"[43 flash at FLUX.1-dev] {what} (bucket 128): forward max_abs {fwd_err:.3g}, kernel {fwd_ms:.4f} ms, "
          f"plain {fwd_plain:.4f} ms, sdpa {fwd_sdpa:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}); backward max_abs "
          f"{bwd_err:.3g} worst rel_l2 {bwd_rel:.3g}, two calls bit-identical, kernels {bwd_ms:.4f} ms (profiled: "
          f"pass (a) {pass_a:.4f} ms, pass (b) {pass_b:.4f} ms), plain {bwd_plain:.4f} ms, sdpa bwd "
          f"{bwd_sdpa:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by})", flush=True)
    calls, rope_calls = _flux_step_calls(b)
    entries = []
    for d, err, ms, plain_ms, bound_ms, bound_by, lib_ms, extra in (
        ("fwd", fwd_err, fwd_ms, fwd_plain, fwd_bound, fwd_by, fwd_sdpa, {}),
        ("bwd", bwd_err, bwd_ms, bwd_plain, bwd_bound, bwd_by, bwd_sdpa,
         {"pass_a_ms": pass_a, "pass_b_ms": pass_b}),
    ):
        entries.append(_entry(
            f"flash_attention_{d}[b={b} n={n} heads={heads} hd={hd}]", f"flash_attention_{d}.cu", FLASH_REPLACES[d],
            err, ms, plain_ms, bound_ms, bound_by, lib_ms, launches=calls[f"flash_{d}", n],
            launches_per_train_step=calls[f"flash_{d}", n], path=FLUX_STEP_PATH,
            qk_norm_rope_calls_per_train_step=rope_calls["qk_norm_rope" if d == "fwd" else "qk_norm_rope_bwd", n],
            **extra))
    return entries, calls

def phase_flash_layer() -> dict[tuple[str, int], int]:
    """CosineAttention(use_pallas=True) against use_pallas=False on the same
    weights, forward and backward; returns the flash calls of the layers'
    use_pallas runs."""
    import torch

    from tinyedm_tpu_torch.models.edm import init_weights
    from tinyedm_tpu_torch.models.layers import CosineAttention
    from tinyedm_tpu_torch.ops import attention as fl

    calls = {}
    for b, c, side in FLASH_LAYERS:
        n = side * side
        flash = CosineAttention(c, HEADS, dtype=torch.bfloat16, use_pallas=True)
        init_weights(flash, torch.Generator().manual_seed(c))
        flash = flash.cuda()
        ref = CosineAttention(c, HEADS, dtype=torch.bfloat16).cuda()
        ref.load_state_dict(flash.state_dict())
        gen = torch.Generator(device="cuda").manual_seed(side)
        x = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        results = []
        for module in (flash, ref):
            xr = x.clone().requires_grad_(True)
            fl.launch_counts.clear()
            out = module(xr)
            (dx,) = torch.autograd.grad(out, xr, g)
            torch.cuda.synchronize()
            results.append((out.detach(), dx, dict(fl.launch_counts)))
        (out, dx, counts), (rout, rdx, rcounts) = results
        if counts != {("flash_fwd", n): 1, ("flash_bwd", n): 1} or rcounts:
            fail(f"flash layer at n={n} launched {counts} (reference {rcounts}), "
                 "expected one flash forward and one flash backward call")
        if not (torch.isfinite(out.float()).all() and torch.isfinite(dx.float()).all()):
            fail(f"flash layer at n={n}: non-finite output or gradient")
        out_err, dx_err = rel_l2(out, rout), rel_l2(dx, rdx)
        print(f"[6 flash layer] CosineAttention({c}, {HEADS} heads, bf16, use_pallas=True) at "
              f"({b}, {c}, {side}, {side}), n={n}: calls {_fmt(counts)}; against use_pallas=False "
              f"output rel L2 {out_err:.3g} (<= 1e-2), input gradient {dx_err:.3g} (<= 2e-2)", flush=True)
        if not (out_err <= 1e-2 and dx_err <= 2e-2):
            fail(f"flash layer at n={n}: output {out_err} or input gradient {dx_err} off the limits")
        calls.update(counts)
        del flash, ref, results, out, dx, rout, rdx
        torch.cuda.empty_cache()
    return calls


def _seeded(config: str, seed: int = 0, fused_form: str = "auto"):
    """The config's model on the card with weights drawn from ``seed`` and
    gain_out = 1 (at its init value 0 the output is c_skip * x whatever the
    network computes)."""
    import torch

    from tinyedm_tpu_torch.configs import build_model

    model = build_model(config, "cuda", seed=seed, fused=fused_form)
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    return model


def _seeded_models(config: str, fused_form: str = "auto"):
    """The config's model with seeded weights and gain_out = 1 (at its init
    value 0 the output is c_skip * x whatever the network computes), in the
    attention form ``fused_form`` and unfused, with the same weights."""
    import torch

    from tinyedm_tpu_torch.configs import model_from_config

    fused = _seeded(config, fused_form=fused_form)
    with torch.device("cuda"):
        unfused = model_from_config(config, fused="off").eval()
    unfused.load_state_dict(fused.state_dict())
    return fused, unfused


def _flash_calls() -> dict:
    from tinyedm_tpu_torch.ops import attention as fl

    return {k: v for k, v in fl.launch_counts.items() if v}


def _clear_counts() -> None:
    from tinyedm_tpu_torch.ops import attention as fl
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops import mp

    from tinyedm_tpu_torch.ops import rope

    fa.launch_counts.clear()
    fl.launch_counts.clear()
    rope.call_counts.clear()
    mp.weight_norm_cast.launches = mp.weight_norm_cast.bwd_launches = 0


def _wn_layers_run(model) -> int:
    """The weight-normed layers a forward of ``model`` runs: all but the
    uncertainty head's (``u``), which only the training loss reads."""
    from tinyedm_tpu_torch.models.layers import _WeightNormed

    return sum(isinstance(m, _WeightNormed) for name, m in model.named_modules() if not name.startswith("u."))


def phase_forward(tag: str, config: str, fused, unfused, kind: str = "fwd") -> None:
    """One forward of the model, whose attention launches ``kind`` kernels
    ("fwd": the fused attention; "block_fwd": the whole block), against the
    unfused model."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    p = PATHS[config]
    b, side = p["batch"], p["side"]
    channels = fused.denoiser.conv_in.weight.shape[1] - 1
    g = torch.Generator(device="cuda").manual_seed(1)
    sigma = torch.exp(torch.randn((b,), generator=g, device="cuda") * 1.2 - 1.2)
    x = torch.randn((b, channels, side, side), generator=g, device="cuda")
    x = x * (0.5**2 + sigma**2).sqrt().reshape(-1, 1, 1, 1)
    labels = None
    if p["classes"]:
        labels = torch.randint(0, p["classes"], (b,), generator=g, device="cuda")
    with torch.inference_mode():
        _clear_counts()
        out = fused(x, sigma, labels)
        torch.cuda.synchronize()
        counts, flash = dict(fa.launch_counts), _flash_calls()
        ref = unfused(x, sigma, labels)
    expected = {(kind, n): c for n, c in p["calls"].items()}
    if counts != expected or flash:
        fail(f"one {config} forward launched {counts} and flash {flash}, expected {expected} and none")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"forward output {tuple(out.shape)} not finite or not {tuple(x.shape)}")
    err = rel_l2(out, ref)
    print(f"[{tag} forward] {config} EDM b={b} bf16, {kind} route: {sum(counts.values())} launches {_fmt(counts)}, "
          f"flash launches 0 (the topology attends at n = {', '.join(map(str, sorted(p['calls'])))} only); "
          f"fused vs unfused rel L2 {err:.3g} (<= 1e-2)", flush=True)
    if not err <= 1e-2:
        fail(f"fused vs unfused forward rel L2 {err} > 1e-2")


@contextlib.contextmanager
def _edm_forwards():
    """Counts the EDM forwards by batch size while active (CFG's stacked
    forwards run at twice the batch), through a wrapper of ``EDM.forward``:
    a global module hook would put every module call on nn.Module's slow
    path and slow the host-bound forward down."""
    from tinyedm_tpu_torch.models.edm import EDM

    by_batch = Counter()
    forward = EDM.forward

    def counted(self, noisy_image, *args, **kwargs):
        by_batch[noisy_image.shape[0]] += 1
        return forward(self, noisy_image, *args, **kwargs)

    EDM.forward = counted
    try:
        yield by_batch
    finally:
        EDM.forward = forward


def phase_sample(tag: str, config: str, fused, what: str, forwards: dict[int, int],
                 beside: dict | None = None, guide=None, **options) -> dict:
    """generate() for one batch of the config with the sampler and guidance
    ``options`` (its keywords), 32 steps, the weights of ``fused`` (and
    ``guide`` as the autoguidance model) saved with save_weights; then the
    same with fused="off" (samples within 2e-2 relative L2). ``forwards``:
    the EDM forwards expected by batch size. Returns the fused run's kernel
    launches, img/s and seconds; ``beside`` (another run's) is printed
    beside them."""
    import torch

    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops import mp
    from tinyedm_tpu_torch.utils.interop import save_weights

    p = PATHS[config]
    b = p["batch"]
    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / f"{config}_seed0.pt"
        save_weights(fused, weights, config)
        kwargs = dict(weights=str(weights), device="cuda", num_steps=32, seed=0, keep_samples=True,
                      num_classes=p["classes"] or 0, **p["denorm"], **options)
        if guide is not None:
            kwargs["guide_weights"] = str(Path(tmp) / f"{config}_guide.pt")
            save_weights(guide, kwargs["guide_weights"], config)
        with _edm_forwards() as seen:
            _clear_counts()
            result = generate(str(Path(tmp) / "fused"), b, p["side"], b, **kwargs)
            counts, flash, by_batch = dict(fa.launch_counts), _flash_calls(), dict(seen)
            wn_launches = mp.weight_norm_cast.launches
        pngs = sorted((Path(tmp) / "fused").glob("*.png"))
        color_types = {png.read_bytes()[25] for png in pngs}  # IHDR's color type byte
        ref = generate(str(Path(tmp) / "off"), b, p["side"], b, fused="off", **kwargs)
    expected = {("fwd", n): c * sum(forwards.values()) for n, c in p["calls"].items()}
    if counts != expected or flash or by_batch != forwards:
        fail(f"{what} launched {counts} and flash {flash} in forwards by batch {by_batch}, expected "
             f"{expected}, none and {forwards}")
    if len(pngs) != b or color_types != {p["color"]}:
        fail(f"{what} wrote {len(pngs)} PNGs of color types {color_types}, expected {b} of {p['color']}")
    samples = torch.from_numpy(result["samples"])
    if not torch.isfinite(samples).all():
        fail(f"{what} samples not finite")
    err = rel_l2(samples, torch.from_numpy(ref["samples"]))
    other = ""
    if beside:
        other = (f"; {beside['what']} in this run: {beside['img_per_s']:.2f} img/s ({beside['seconds']:.3f} s, "
                 f"this run {result['seconds'] / beside['seconds']:.3f}x its wall time)")
    print(f"[{tag} {what}] {config}: {b} samples at batch {b}: {sum(by_batch.values())} forwards by batch "
          f"{dict(sorted(by_batch.items()))}, {sum(counts.values())} launches {_fmt(counts)}, weight_norm_cast "
          f"{wn_launches}, {len(pngs)} PNGs "
          f"(color type {p['color']}), {result['img_per_s']:.2f} img/s ({result['seconds']:.3f} s), peak "
          f"{result['peak_bytes'] / 2**30:.3f} GiB; unfused solve {ref['img_per_s']:.2f} img/s; fused vs "
          f"unfused samples rel L2 {err:.3g} (<= 2e-2){other}", flush=True)
    if not err <= 2e-2:
        fail(f"fused vs unfused {what} samples rel L2 {err} > 2e-2")
    return dict(counts=counts, wn_launches=wn_launches, forwards=sum(by_batch.values()), img_per_s=result["img_per_s"],
                seconds=result["seconds"], what=f"{what} (phase {tag})")


def phase_churn_seeds(tag: str, fused) -> None:
    """The churn solve's randomness is its generator's: the same seed twice
    within 1e-5 relative L2, another seed more than 1e-1 away (same noise)."""
    import torch

    from tinyedm_tpu_torch.diffusion.solver import StochasticSolver

    p = PATHS["cifar10"]
    solver = StochasticSolver(num_steps=32, S_churn=CHURN["s_churn"], S_min=CHURN["s_min"],
                              S_max=CHURN["s_max"], S_noise=CHURN["s_noise"])
    x0 = torch.randn((p["batch"], 3, p["side"], p["side"]), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.inference_mode():
        a, b, c = (solver.solve(fused, x0, generator=torch.Generator(device="cuda").manual_seed(s))
                   for s in (11, 11, 12))
        same, other = rel_l2(b, a), rel_l2(c, a)
    print(f"[{tag} churn seeds] cifar10 churn Heun-32 from one noise: the same generator seed twice rel L2 "
          f"{same:.3g} (<= 1e-5), another seed {other:.3g} (> 1e-1)", flush=True)
    if not (same <= 1e-5 and other > 1e-1):
        fail(f"churn: same seed {same} (<= 1e-5), another seed {other} (> 1e-1)")


def phase_train(tag: str, config: str, fused: str = "auto", beside: dict | None = None,
                label_dropout: float = 0.0, eval_profiles: int | None = None) -> dict:
    """The config's recipe train step at full width on seeded synthetic
    data, its attention in the form ``fused`` ("auto" or "block"), with
    ``label_dropout``; returns the kernel calls of the warm-up and timed
    steps, ms/step, samples/s and the peak memory. ``beside``: another
    form's numbers from this run, printed beside these. ``eval_profiles``:
    then one make_eval_step call with that many EMA profiles on the last
    batch (finite sums, count = batch), fused against unfused."""
    import torch

    from tinyedm_tpu_torch.configs import build_training, model_from_config
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
    from tinyedm_tpu_torch.models.layers import _WeightNormed
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops import mp
    from tinyedm_tpu_torch.training.state import weight_normed_names
    from tinyedm_tpu_torch.training.train_step import (
        init_train_state,
        make_eval_step,
        make_grad_fn,
        make_train_step,
    )

    p = PATHS[config]
    model, diffuser, opt_cfg, ema_cfg, batch, interval = build_training(config, "cuda", seed=0,
                                                                        fused=fused)
    opt_cfg = dataclasses.replace(opt_cfg, label_dropout=label_dropout)
    a = opt_cfg.accum_steps
    batch = a * p["microbatch"] if "microbatch" in p else batch
    steps = p["warmup"] + p["timed"]
    channels = model.denoiser.conv_in.weight.shape[1] - 1
    data = SyntheticDataModule(batch, image_size=p["side"], num_channels=channels,
                               num_samples=batch * steps, num_classes_=p["classes"] or 10, seed=0)
    batches = [to_device(x, y, "cuda") for x, y in data.train_batches(0)]  # set-up, not timed

    def count(i: int) -> int:  # the lr schedule's count: per step or per epoch
        return p["sched"] + i if interval == "step" else p["sched"]

    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics_seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _clear_counts()
    t_warm = time.perf_counter()
    for i in range(p["warmup"]):
        state, metrics = step(state, batches[i], gen, count(i))
        metrics_seen.append(metrics)
        if i == 0 and not all(torch.equal(tree[k], prm) for tree in state.ema
                              for k, prm in state.params.items()):
            fail("an EMA tree differs from the params after step 0 (decay 0)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(p["warmup"], steps):
        state, metrics = step(state, batches[i], gen, count(i))
        metrics_seen.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, flash = dict(fa.launch_counts), _flash_calls()
    wn = (mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    kinds = ("fwd", "bwd") if fused == "auto" else (f"{fused}_fwd", f"{fused}_bwd")
    expected = {(d, n): a * c * steps for n, c in p["calls"].items() for d in kinds}
    if counts != expected or flash:
        fail(f"{steps} train steps made {counts} and flash {flash}, expected {expected} and none")
    # every weight-normed layer runs in a training forward, the uncertainty head's too
    wn_layers = sum(isinstance(m, _WeightNormed) for m in model.modules())
    if wn != (a * wn_layers * steps,) * 2:
        fail(f"{steps} train steps launched weight_norm_cast {wn[0]} times forward and {wn[1]} backward, expected "
             f"{a * wn_layers * steps} each way ({a} x {wn_layers} a step)")
    losses = torch.stack([m["train_loss"] for m in metrics_seen]).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite train loss: {losses.tolist()}")
    uncertainty = ""
    if model.u is not None:
        u = torch.stack([m["uncertainty"] for m in metrics_seen]).float().cpu()
        if not torch.isfinite(u).all():
            fail(f"non-finite uncertainty: {u.tolist()}")
        uncertainty = f", uncertainty {u[0]:.4g} .. {u[-1]:.4g}"
    for k in weight_normed_names(model):
        prm = state.params[k]
        rms = prm.detach().reshape(prm.shape[0], -1).pow(2).mean(dim=1).sqrt()
        if not torch.allclose(rms, torch.ones_like(rms), atol=1e-3):
            fail(f"{k}: per-output RMS {rms.min().item()}..{rms.max().item()} after the step, not 1")
    ms = 1e3 * seconds / p["timed"]
    result = dict(counts=counts, ms=ms, samples_per_s=batch / ms * 1e3, peak_gib=peak / 2**30, wn_launches=wn,
                  wn_per_step=wn[0] // steps)
    other = ""
    if beside:
        other = (f"; the fused=\"auto\" route in this run (phase 9): {beside['ms']:.3f} ms/step, "
                 f"{beside['samples_per_s']:.2f} samples/s, peak {beside['peak_gib']:.3f} GiB")
    print(f"[{tag} train] {config} recipe b={batch} ({a} x {batch // a}) bf16 fused={fused!r}, label dropout "
          f"{label_dropout}, {len(state.ema)} EMA "
          f"profile(s), lr schedule count {count(0)} ({interval}): {p['warmup']} warm-up steps in "
          f"{time.perf_counter() - t_warm - seconds:.3f} s, {p['timed']} timed steps {ms:.3f} ms/step, "
          f"{batch / ms * 1e3:.2f} samples/s, peak {peak / 2**30:.3f} GiB; calls {_fmt(counts)}, flash 0, "
          f"weight_norm_cast {wn[0] // steps} forward and {wn[1] // steps} backward a step; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}{uncertainty}{other}", flush=True)

    # one step's gradients, fused against fused="off", from the same state
    with torch.device("cuda"):
        unfused = model_from_config(config, fused="off").eval()
    unfused.load_state_dict(model.state_dict())
    ustate = dataclasses.replace(state, params=dict(unfused.named_parameters()))
    grads, ugrads = (
        make_grad_fn(m, diffuser, opt_cfg)(
            st, *batches[-1], torch.Generator(device="cuda").manual_seed(1)
        )[2]
        for m, st in ((model, state), (unfused, ustate))
    )
    # the WN weights' gradients (all but a few dozen of the values): the
    # scalar gains' gradients are few and large, and would decide a global norm
    names = weight_normed_names(model)
    pairs = [(g, u) for k, g, u in zip(state.params, grads, ugrads) if k in names]
    err = rel_l2(torch.cat([g.reshape(-1) for g, _ in pairs]), torch.cat([u.reshape(-1) for _, u in pairs]))
    worst = max(rel_l2(g, u) for g, u in pairs)
    print(f"[{tag} train] one step's gradients of the {len(names)} WN weights "
          f"({sum(g.numel() for g, _ in pairs)} values), fused={fused!r} vs unfused attention: rel L2 {err:.3g} "
          f"(<= 2e-2), worst single weight {worst:.3g}; all {len(grads)} parameters "
          f"{rel_l2(torch.cat([g.reshape(-1) for g in grads]), torch.cat([u.reshape(-1) for u in ugrads])):.3g}",
          flush=True)
    if not err <= 2e-2:
        fail(f"fused={fused!r} vs unfused WN weight gradients rel L2 {err} > 2e-2")
    if eval_profiles is not None:
        del grads, ugrads
        kw = dict(n_profiles=eval_profiles, use_ema=eval_profiles > 0)
        _clear_counts()
        out = make_eval_step(model, diffuser, **kw)(state, batches[-1], 0)
        counts = _kernel_calls()
        ref = make_eval_step(unfused, diffuser, **kw)(ustate, batches[-1], 0)
        # one forward per profile; the EMA-weighted primary is profile 0's
        expected = {("fwd", n): c * max(1, eval_profiles) for n, c in p["calls"].items()}
        values = {k: float(v) for k, v in out.items()}
        errs = {k: abs(values[k] - float(ref[k])) / abs(float(ref[k])) for k in out if k != "count"}
        print(f"[{tag} eval] {config} make_eval_step b={batch}, {eval_profiles} EMA profile(s): {values}, "
              f"calls {_fmt(counts)}; fused vs unfused relative difference {max(errs.values()):.3g} (<= 2e-2)",
              flush=True)
        if counts != expected:
            fail(f"eval step launched {counts}, expected {expected}")
        if not all(map(math.isfinite, values.values())) or values["count"] != batch:
            fail(f"eval step: {values}, expected finite sums and count {batch}")
        if not max(errs.values()) <= 2e-2:
            fail(f"eval step fused vs unfused: {errs}")
    return result


def _write_cifar10(directory: Path, seed: int = 0, n_train: int = LOOP_TRAIN_BATCH, n_test: int = LOOP_TEST) -> None:
    """CIFAR-10's python pickle batches with seeded uint8 images and labels:
    five train batches of ``n_train`` images and a test batch of ``n_test``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", n_train) for i in range(1, 6)] + [("test_batch", n_test)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8), b"labels": rng.integers(0, 10, n).tolist()}
        with open(directory / name, "wb") as f:
            pickle.dump(batch, f)


def _run_train(args: list[str], tag: str = "24 run loop"):
    """tinyedm_tpu_torch.train.main(args) with its output echoed under
    ``tag``; returns (trainer, output, seconds to the end of the run on the
    card)."""
    import torch

    from tinyedm_tpu_torch import train

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer = train.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        print(f"[{tag}]   {line}", flush=True)
    return trainer, out.getvalue(), seconds


def phase_run_loop(smi: str, bare: dict) -> tuple[dict, float]:
    """The run loop at CIFAR-10 full width (docstring, phase 24). ``bare``:
    phase 9's result, printed beside the loop's. Returns the fused kernels'
    launches per loop step by (direction, n), and the loop's ms/step."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch.configs import build_model
    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
    from tinyedm_tpu_torch.utils.interop import save_weights

    p = PATHS["cifar10"]
    calls = p["calls"]  # fused launches of one forward, by n
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_cifar10(tmp / "cifar10")
        run = tmp / "run"
        args = ["--config-name=cifar10", f"--config-path={ROOT / 'experiments' / 'conf'}",
                f"datamodule.data_dir={tmp / 'cifar10'}", f"trainer.out_dir={run}", f"trainer.max_epochs={LOOP_EPOCHS}",
                "trainer.check_val_every_n_epoch=1", "callbacks.checkpoint_callback.every_n_epochs=1",
                "callbacks.generate_callback.every_n_epochs=1"]
        torch.cuda.reset_peak_memory_stats()
        _clear_counts()
        trainer, _, fit_s = _run_train(args)
        counts, flash = _kernel_calls(), _flash_calls()
        peak = torch.cuda.max_memory_allocated()
        batch = trainer.datamodule.batch_size
        spe = trainer.datamodule.steps_per_epoch()
        steps = LOOP_EPOCHS * spe
        val_batches = -(-LOOP_TEST // batch)
        forwards = steps + LOOP_EPOCHS * (val_batches + LOOP_PREVIEW_FORWARDS)
        expected = {(d, n): c * (forwards if d == "fwd" else steps) for n, c in calls.items() for d in ("fwd", "bwd")}
        if trainer.global_step != steps or counts != expected or flash:
            fail(f"run loop: {trainer.global_step} steps, launches {counts} and flash {flash}; expected {steps}, "
                 f"{expected} and none")
        # the loop's own: the forwards outside it are the validations' and previews'
        outside = LOOP_EPOCHS * (val_batches + LOOP_PREVIEW_FORWARDS)
        per_step = {(d, n): (c - (outside * calls[n] if d == "fwd" else 0)) // steps for (d, n), c in counts.items()}

        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        epoch_rows = [r for r in rows if "samples_per_sec" in r]
        val_rows = [r for r in rows if "val_loss" in r]
        want = [spe * (e + 1) for e in range(LOOP_EPOCHS)]
        finite = all(math.isfinite(r[k]) for r in epoch_rows for k in ("train_loss", "samples_per_sec"))
        if [r["step"] for r in epoch_rows] != want or [r["step"] for r in val_rows] != want or not finite or \
                not all(math.isfinite(r["val_loss"]) for r in val_rows):
            fail(f"run loop metrics rows: epoch rows {epoch_rows}, val rows {val_rows}; expected finite rows at {want}")
        grids = sorted(x.name for x in (run / "images").glob("Generated_*.png"))
        if grids != [f"Generated_{e:07d}.png" for e in range(LOOP_EPOCHS)]:
            fail(f"run loop previews: {grids}")
        top_k = trainer.ckpt._max_to_keep
        kept = sorted(sorted(want, key=lambda s: next(r["val_loss"] for r in val_rows if r["step"] == s))[:top_k])
        on_disk = sorted(int(x.name) for x in (run / "checkpoints").iterdir() if x.name.isdigit())
        if on_disk != kept:
            fail(f"run loop checkpoints on disk {on_disk}, top-{top_k} retention keeps {kept}")

        # the latest checkpoint restored bit for bit
        restored, config = trainer.ckpt.restore(device="cuda")
        live = trainer.state
        trees = [(live.params, restored.params), (live.constants, restored.constants), (live.mu, restored.mu),
                 (live.nu, restored.nu)] + list(zip(live.ema, restored.ema))
        same = all(set(a) == set(b) and all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
                   for a, b in trees)
        if not (same and (restored.step, restored.count) == (live.step, live.count) and len(restored.ema) == 1):
            fail("run loop: the restored checkpoint differs from the trained state")

        # one validation, one save and one restore, timed on the card
        val_loss, val_s, val_counts = _timed_validate(trainer)
        if val_counts != {("fwd", n): c * val_batches for n, c in calls.items()} or not math.isfinite(val_loss):
            fail(f"validation: val_loss {val_loss}, launches {val_counts}")
        timed = CheckpointManager(tmp / "timed", max_to_keep=None, monitor=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.save(live.step, live, config=config)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = timed.restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mb = (tmp / "timed" / str(live.step) / "state.pt").stat().st_size / 1e6
        if not all(torch.equal(live.params[k], again.params[k]) for k in live.params):
            fail("run loop: the timed save does not restore bit for bit")
        del again, restored, trees, live, trainer
        torch.cuda.empty_cache()
        sps = epoch_rows[-1]["samples_per_sec"]
        loop_ms = 1e3 * batch / sps
        print(f"[24 run loop] cifar10.yaml via tinyedm_tpu_torch.train, {LOOP_EPOCHS} epochs x {spe} steps of {batch} "
              f"(5 x {LOOP_TRAIN_BATCH} synthetic images; val {LOOP_TEST} = {val_batches} batches), {fit_s:.3f} s "
              f"in all: launches {_fmt(counts)}, flash 0; per loop step {_fmt(per_step)}; train_loss "
              f"{epoch_rows[0]['train_loss']:.4f} .. {epoch_rows[-1]['train_loss']:.4f}, val_loss "
              f"{val_rows[0]['val_loss']:.4f} .. {val_rows[-1]['val_loss']:.4f}; previews {grids}; checkpoints "
              f"{on_disk} (top-{top_k}), the latest restored bit for bit", flush=True)
        print(f"[24 run loop] loop (epoch {LOOP_EPOCHS}, samples_per_sec of metrics.jsonl): {loop_ms:.3f} ms/step, "
              f"{sps:.2f} samples/s; the bare train step in this run (phase 9): {bare['ms']:.3f} ms/step, "
              f"{bare['samples_per_s']:.2f} samples/s (loop / bare {loop_ms / bare['ms']:.3f}); validation "
              f"{val_s:.3f} s ({LOOP_TEST} images, {val_batches} batches); checkpoint save {save_s:.3f} s, restore "
              f"{restore_s:.3f} s, {mb:.1f} MB on disk; peak {peak / 2**30:.3f} GiB | {smi}", flush=True)

        # resume to the third epoch
        resumed, out, resume_s = _run_train(args[:4] + [a for a in args[4:] if not a.startswith("trainer.max_epochs")]
                                            + ["--resume", "--max-epochs", str(LOOP_RESUMED_EPOCHS)])
        del resumed  # its model and state leave the card before the sampling runs
        torch.cuda.empty_cache()
        resumed_rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()][len(rows) + 1:]
        line = f"[trainer] resumed at step {steps} (epoch {LOOP_EPOCHS})"
        final = [r for r in resumed_rows if "samples_per_sec" in r]
        end = LOOP_RESUMED_EPOCHS * spe
        if line not in out or [r["step"] for r in final] != [end] or not all(
                math.isfinite(v) for r in resumed_rows for k, v in r.items() if k != "time"):
            fail(f"resume: expected {line!r} and finite rows ending at step {end}, got {resumed_rows}")
        print(f"[24 run loop] --resume --max-epochs {LOOP_RESUMED_EPOCHS}: '{line}', ended at step {end} in "
              f"{resume_s:.3f} s, train_loss {final[0]['train_loss']:.4f}, all {len(resumed_rows)} rows finite",
              flush=True)

        # sample the EMA checkpoint through the CLI, and from the same weights passed directly
        ckpt = str(run / "checkpoints")
        n = 128
        from_ckpt = _cli_generate(["--ckpt_path", ckpt, "--load_ema", "--num_samples", str(n), "--batch_size", str(n),
                                   "--output_dir", str(tmp / "cli")])
        pngs = sorted((tmp / "cli").glob("*.png"))
        state, _ = CheckpointManager(ckpt).restore()
        model = build_model("cifar10", "cpu")
        model.load_state_dict({**state.ema[0], **state.constants})
        save_weights(model, tmp / "ema.pt", "cifar10")
        direct = generate(str(tmp / "direct"), n, 32, n, weights=str(tmp / "ema.pt"), keep_samples=True)
        same_png = all((tmp / "cli" / x.name).read_bytes() == (tmp / "direct" / x.name).read_bytes() for x in pngs)
        equal = np.array_equal(from_ckpt["samples"], direct["samples"])
        if len(pngs) != n or not same_png or not equal or not np.isfinite(direct["samples"]).all():
            fail(f"generate --ckpt_path --load_ema: {len(pngs)} PNGs, PNGs equal {same_png}, samples equal {equal}")
        print(f"[24 run loop] generate --ckpt_path --load_ema (step {state.step}): {len(pngs)} PNGs, samples equal bit "
              f"for bit to generate() from the EMA weights as a weights file ({from_ckpt['img_per_s']:.2f} img/s "
              f"Heun-32 at batch {n})", flush=True)
    return per_step, loop_ms


def _cli_generate(argv: list[str]) -> dict:
    """``python -m tinyedm_tpu_torch.generate`` (its ``main``) on ``argv``,
    with the samples its generate() call kept: the CLI's own result, in
    place of a second, equivalent generate(ckpt_path=...) solve."""
    from tinyedm_tpu_torch import generate as gen

    kept = []
    real = gen.generate

    def keeping(*args, **kwargs):
        kept.append(real(*args, **{**kwargs, "keep_samples": True}))
        return kept[-1]

    gen.generate = keeping
    try:
        gen.main(argv)
    finally:
        gen.generate = real
    return kept[-1]


def _write_latents(root: Path, n: int, seed: int):
    """``n`` synthetic samples as the JAX extractor writes them: CHW fp32
    latents and int64 labels, one ``{i}.npy`` each under ``latents/`` and
    ``labels/``; returns (latents, labels)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((n, 4, 64, 64), dtype=np.float32)
    lab = rng.integers(0, 1000, n)
    (root / "latents").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        np.save(root / "latents" / f"{i}.npy", lat[i])
        np.save(root / "labels" / f"{i}.npy", np.int64(lab[i]))
    return lat, lab


@contextlib.contextmanager
def _timed_saves():
    """Seconds of each ``CheckpointManager.save`` while active (the card
    synchronized first), by step."""
    import torch

    from tinyedm_tpu_torch.training.checkpoint import CheckpointManager

    seconds = {}
    save = CheckpointManager.save

    def timed(self, step, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, step, *args, **kwargs)
        seconds[step] = time.perf_counter() - t0

    CheckpointManager.save = timed
    try:
        yield seconds
    finally:
        CheckpointManager.save = save


def _state_gb(directory: Path, step: int) -> float:
    return (directory / str(step) / "state.pt").stat().st_size / 1e9


def _loop_numbers(run: Path, batch: int) -> tuple[list, list, float, float]:
    """(epoch rows, val rows, ms/step and samples/s of the last epoch) of a
    run's metrics.jsonl."""
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    epoch_rows = [r for r in rows if "samples_per_sec" in r]
    val_rows = [r for r in rows if "val_loss" in r]
    sps = epoch_rows[-1]["samples_per_sec"]
    return epoch_rows, val_rows, 1e3 * batch / sps, sps


def _timed_validate(trainer) -> tuple[float, float, dict]:
    """(val_loss, seconds, fused launches) of one validation, without the
    callbacks that run after it (a latent preview)."""
    import torch

    callbacks, trainer.callbacks = trainer.callbacks, []
    _clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        val_loss = trainer.validate()
        torch.cuda.synchronize()
    finally:
        trainer.callbacks = callbacks
    return val_loss, time.perf_counter() - t0, _kernel_calls()


def phase_imagenet64_cli(smi: str, bare: dict) -> dict:
    """imagenet.yaml through tinyedm_tpu_torch.train with
    datamodule.batch_size=528 (docstring, phase 25). ``bare``: phase 23's
    result. Returns the fused launches per loop step by (direction, n)."""
    import torch

    p = PATHS["imagenet"]
    calls, a = p["calls"], IN64_BATCH // p["microbatch"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _write_latents(tmp / "latents" / "train", IN64_STEPS * IN64_BATCH, seed=0)
        _write_latents(tmp / "latents" / "val", IN64_VAL, seed=1)
        write_s = time.perf_counter() - t0
        run = tmp / "run"
        args = ["--config-name=imagenet", f"--config-path={ROOT / 'experiments' / 'conf'}",
                f"datamodule.data_dir={tmp / 'latents'}", f"datamodule.batch_size={IN64_BATCH}",
                f"trainer.out_dir={run}", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
                "callbacks.checkpoint_callback.every_n_epochs=1", "callbacks.generate_callback=null"]
        torch.cuda.reset_peak_memory_stats()
        _clear_counts()
        with _timed_saves() as saves:
            trainer, _, fit_s = _run_train(args, "25 imagenet-64 cli")
        counts, flash = _kernel_calls(), _flash_calls()
        peak = torch.cuda.max_memory_allocated()
        epoch_rows, val_rows, loop_ms, sps = _loop_numbers(run, IN64_BATCH)
        val_loss, val_s, val_counts = _timed_validate(trainer)
        spec = trainer.spec
        train_fwd = {n: IN64_STEPS * a * c for n, c in calls.items()}
        expected = {**{("fwd", n): train_fwd[n] + c for n, c in calls.items()},
                    **{("bwd", n): train_fwd[n] for n in calls}}
        ok = (trainer.global_step == IN64_STEPS and spec.accum_steps == a and counts == expected and not flash
              and val_counts == {("fwd", n): c for n, c in calls.items()} and trainer.ckpt.all_steps == [IN64_STEPS]
              and math.isfinite(val_loss) and all(math.isfinite(r["train_loss"]) for r in epoch_rows)
              and [r["step"] for r in val_rows] == [IN64_STEPS])
        if not ok:
            fail(f"imagenet-64 CLI: {trainer.global_step} steps, accum {spec.accum_steps}, launches {counts} (expected "
                 f"{expected}), flash {flash}, validation launches {val_counts}, checkpoints {trainer.ckpt.all_steps}, "
                 f"val_loss {val_loss}, rows {epoch_rows} {val_rows}")
        gb = _state_gb(run / "checkpoints", IN64_STEPS)
        del trainer
        torch.cuda.empty_cache()
    per_step = {(d, n): a * c for n, c in calls.items() for d in ("fwd", "bwd")}
    print(f"[25 imagenet-64 cli] imagenet.yaml via tinyedm_tpu_torch.train with datamodule.batch_size={IN64_BATCH} "
          f"({a} x {IN64_BATCH // a}, Lightning's reading), {IN64_STEPS} steps on {IN64_STEPS * IN64_BATCH} synthetic "
          f"CHW .npy latents (written in {write_s:.3f} s) and one validation batch of {IN64_VAL}, no preview, "
          f"{fit_s:.3f} s in all: launches {_fmt(counts)}, flash 0; per loop step {_fmt(per_step)} ({a} per "
          f"microbatch x {calls}); train_loss {epoch_rows[-1]['train_loss']:.4f}, val_loss {val_rows[-1]['val_loss']:.4f}",
          flush=True)
    print(f"[25 imagenet-64 cli] loop (1 epoch, samples_per_sec of metrics.jsonl): {loop_ms:.3f} ms/step, {sps:.2f} "
          f"samples/s; the bare 3 x 176 step in this run (phase 23): {bare['ms']:.3f} ms/step (loop / bare "
          f"{loop_ms / bare['ms']:.3f}); validation of {IN64_VAL} in one batch {val_s:.3f} s; checkpoint save "
          f"{saves[IN64_STEPS]:.3f} s, {gb:.3f} GB on disk; peak {peak / 2**30:.3f} GiB | {smi}", flush=True)
    return per_step


def phase_imagenet512_cli(smi: str, bare: dict, tmp: Path, vae_files: dict) -> dict:
    """imagenet512.yaml through tinyedm_tpu_torch.train on a latpack store
    (docstring, phase 26), in ``tmp``, which keeps the run for phase 27,
    with ``$HF_HOME`` on ``vae_files``' cache, so that its previews decode
    (phase 31, run on the trained state before it is freed). ``bare``: phase
    12's result. Returns the run directory, its checkpoint steps and the
    fused launches per loop step by (direction, n)."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch.data.latpack import PackedLatents

    p = PATHS["imagenet512"]
    calls = p["calls"]
    free_gb = shutil.disk_usage(tmp).free / 1e9
    t0 = time.perf_counter()
    _write_latents(tmp / "npy", IN512_SAMPLES, seed=2)
    write_s = time.perf_counter() - t0
    store = tmp / "latents.latpack"
    t0 = time.perf_counter()
    packed = subprocess.run([sys.executable, "-m", "tinyedm_tpu_torch.data.latpack", str(tmp / "npy" / "latents"),
                             str(tmp / "npy" / "labels"), str(store)], cwd=ROOT, capture_output=True, text=True,
                            timeout=600)
    pack_s = time.perf_counter() - t0
    if packed.returncode != 0 or f"packed {IN512_SAMPLES} samples" not in packed.stdout:
        fail(f"latpack CLI: rc {packed.returncode}\n{packed.stdout}\n{packed.stderr}")
    idx = np.asarray([0, IN512_SAMPLES - 1, 17, 17, 500])
    s = PackedLatents(store, gather_threads=8)
    lat, lab = s.gather(idx)
    s.close()
    files = np.stack([np.load(tmp / "npy" / "latents" / f"{i}.npy").transpose(1, 2, 0) for i in idx])
    labels = np.asarray([int(np.load(tmp / "npy" / "labels" / f"{i}.npy")) for i in idx])
    if lat.dtype != np.float32 or not np.array_equal(lat, files) or not np.array_equal(lab, labels):
        fail("latpack: a gather from the store differs from the .npy files")

    run = tmp / "run"
    args = ["--config-name=imagenet512", f"--config-path={ROOT / 'experiments' / 'conf'}",
            f"datamodule.data_file={store}", f"trainer.out_dir={run}", f"trainer.max_epochs={IN512_EPOCHS}",
            "trainer.check_val_every_n_epoch=1", "callbacks.checkpoint_callback.every_n_epochs=1",
            "callbacks.generate_callback.every_n_epochs=1"]
    torch.cuda.reset_peak_memory_stats()
    _clear_counts()
    with _timed_saves() as saves, _hf_home(vae_files["hf_home"]):
        trainer, run_output, fit_s = _run_train(args, "26 imagenet-512 cli")
    counts, flash = _kernel_calls(), _flash_calls()
    peak = torch.cuda.max_memory_allocated()
    dm = trainer.datamodule
    spe, a, batch = dm.steps_per_epoch(), trainer.spec.accum_steps, dm.batch_size
    steps = IN512_EPOCHS * spe
    epoch_rows, val_rows, loop_ms, sps = _loop_numbers(run, batch)
    val_loss, val_s, val_counts = _timed_validate(trainer)
    n_profiles = len(trainer.state.ema)
    val_fwd = -(-dm._n_val // batch) * n_profiles  # one forward per profile and val batch
    outside = IN512_EPOCHS * (val_fwd + IN512_PREVIEW[1])  # the forwards of validations and previews
    expected = {**{("fwd", n): (steps * a + outside) * c for n, c in calls.items()},
                **{("bwd", n): steps * a * c for n, c in calls.items()}}
    want = [spe * (e + 1) for e in range(IN512_EPOCHS)]
    grids = sorted(x.name for x in (run / "images").glob("Generated_*.png"))
    ok = (type(dm).__name__ == "PackedLatentsDataModule" and dm.prefetch and a == 4 and n_profiles == 2
          and trainer.global_step == steps and counts == expected and not flash
          and val_counts == {("fwd", n): val_fwd * c for n, c in calls.items()} and trainer.ckpt.all_steps == want
          and [r["step"] for r in val_rows] == want and len(grids) == IN512_EPOCHS
          and all(math.isfinite(r[k]) for r in val_rows for k in r if k.startswith("val_loss"))
          and all(math.isfinite(r["train_loss"]) for r in epoch_rows) and math.isfinite(val_loss))
    if not ok:
        fail(f"imagenet-512 CLI: {type(dm).__name__}, accum {a}, {n_profiles} EMA trees, {trainer.global_step} steps, "
             f"launches {counts} (expected {expected}), flash {flash}, validation launches {val_counts}, checkpoints "
             f"{trainer.ckpt.all_steps} (expected {want}), previews {grids}, rows {epoch_rows} {val_rows}")
    # the latest checkpoint restored bit for bit, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, _ = trainer.ckpt.restore(device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live = trainer.state
    trees = [(live.params, restored.params), (live.mu, restored.mu), (live.nu, restored.nu)] + list(
        zip(live.ema, restored.ema))
    if not (all(torch.equal(x[k], y[k]) for x, y in trees for k in x) and restored.step == live.step):
        fail("imagenet-512 CLI: the restored checkpoint differs from the trained state")
    values = sum(v.numel() for v in live.params.values())
    del restored, trees, live
    phase_preview(smi, trainer, run_output, [run / "images" / g for g in grids])
    del trainer
    torch.cuda.empty_cache()
    gb = _state_gb(run / "checkpoints", want[-1])
    per_step = {(d, n): a * c for n, c in calls.items() for d in ("fwd", "bwd")}
    print(f"[26 imagenet-512 cli] {IN512_SAMPLES} synthetic CHW .npy latents written in {write_s:.3f} s, packed by "
          f"python -m tinyedm_tpu_torch.data.latpack in {pack_s:.3f} s (g++ build included): "
          f"{store.stat().st_size / 1e6:.1f} MB; a gather of {len(idx)} rows equals the .npy files bit for bit; "
          f"{free_gb:.1f} GB free in the temporary directory", flush=True)
    print(f"[26 imagenet-512 cli] imagenet512.yaml via tinyedm_tpu_torch.train on the store (prefetch on), "
          f"{IN512_EPOCHS} epochs x {spe} steps of {batch} ({a} x {batch // a}), {n_profiles} EMA profiles, "
          f"validation ({dm._n_val} samples), a Heun-32 preview of {IN512_PREVIEW[0]} and a checkpoint every epoch, "
          f"{fit_s:.3f} s in all: launches {_fmt(counts)}, flash 0; per loop step {_fmt(per_step)} (per microbatch "
          f"{calls} forward and backward); train_loss {epoch_rows[0]['train_loss']:.4f} .. "
          f"{epoch_rows[-1]['train_loss']:.4f}, val_loss {val_rows[0]['val_loss']:.4f} .. "
          f"{val_rows[-1]['val_loss']:.4f}; previews {grids}; checkpoints {want}, the latest restored bit for bit",
          flush=True)
    print(f"[26 imagenet-512 cli] loop (epoch {IN512_EPOCHS}): {loop_ms:.3f} ms/step, {sps:.2f} samples/s; the bare "
          f"4 x 32 step in this run (phase 12): {bare['ms']:.3f} ms/step (loop / bare {loop_ms / bare['ms']:.3f}); "
          f"validation {val_s:.3f} s; checkpoint ({values} values per tree, 5 fp32 trees) saves "
          f"{', '.join(f'{t:.3f}' for t in saves.values())} s, restore {restore_s:.3f} s, {gb:.3f} GB on disk; "
          f"peak {peak / 2**30:.3f} GiB | {smi}", flush=True)
    return dict(run=run, steps=want, per_step=per_step)


def _tree_rel_l2(ours: dict, ref: dict) -> float:
    num = sum(float((ours[k].double() - ref[k].double()).pow(2).sum()) for k in ref)
    den = sum(float(ref[k].double().pow(2).sum()) for k in ref)
    return math.sqrt(num / den)


def phase_posthoc(smi: str, run: Path, steps: list[int], tmp: Path) -> None:
    """Post-hoc EMA over phase 26's checkpoints, then sampling from it
    (docstring, phase 27)."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch import posthoc_ema
    from tinyedm_tpu_torch.configs import build_model
    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
    from tinyedm_tpu_torch.training.ema import sigma_rel_to_gamma, solve_posthoc_weights
    from tinyedm_tpu_torch.utils.interop import save_weights

    ckpt, out = run / "checkpoints", tmp / "posthoc"
    out_io = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_io):
        written = posthoc_ema.main(["--ckpt_path", str(ckpt), "--target_sigma_rel", str(POSTHOC_TARGET),
                                    "--out_dir", str(out), "--steps", *map(str, steps)])
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    for line in out_io.getvalue().splitlines():
        print(f"[27 posthoc]   {line}", flush=True)
    gammas = [sigma_rel_to_gamma(sr) for sr in (0.05, 0.13)] * len(steps)
    w = solve_posthoc_weights([s + 1 for s in steps for _ in range(2)], gammas, steps[-1] + 1,
                              sigma_rel_to_gamma(POSTHOC_TARGET))
    latest, config = CheckpointManager(ckpt).restore(steps[-1], device="cuda")
    err = _tree_rel_l2(written.ema[0], latest.ema[1])  # the tracked 0.13 profile
    del latest
    model_cfg = config["model"]
    if not err <= 1e-5:
        fail(f"post-hoc sigma_rel {POSTHOC_TARGET} at step {steps[-1]}: rel L2 {err} to the tracked tree (> 1e-5)")
    gb = _state_gb(out, steps[-1])
    written_cfg = json.loads((out / str(steps[-1]) / "config.json").read_text())["model"]
    if (written_cfg["ema_length"], written_cfg["ema_lengths"], written_cfg["val_ema_index"]) != (POSTHOC_TARGET, None, 0):
        fail(f"post-hoc output config: {written_cfg}")
    print(f"[27 posthoc] python -m tinyedm_tpu_torch.posthoc_ema over steps {steps} ({2 * len(steps)} snapshots of "
          f"sigma_rels {model_cfg['ema_lengths']}) -> sigma_rel {POSTHOC_TARGET}: weights "
          f"{np.array2string(w, precision=6)}; rel L2 to step {steps[-1]}'s tracked {POSTHOC_TARGET} tree {err:.3g} "
          f"(<= 1e-5); {rec_s:.3f} s (two restores to the card, the combination, the save), {gb:.3f} GB written; "
          f"its config declares one profile", flush=True)

    # sample from it through the CLI, and from the same tree as a weights file
    n = PATHS["imagenet512"]["batch"]
    common = dict(num_classes=1000, num_channels=4, mean=LATENT_MEAN, std=LATENT_STD, keep_samples=True)
    from_ckpt = _cli_generate(["--ckpt_path", str(out), "--load_ema", "--num_classes", "1000", "--num_channels", "4",
                               "--image_size", "64", "--num_samples", str(n), "--batch_size", str(n), "--output_dir",
                               str(tmp / "cli"), "--mean", *map(str, LATENT_MEAN), "--std", *map(str, LATENT_STD)])
    pngs = sorted((tmp / "cli").glob("*.png"))
    model = build_model("imagenet512", "cpu")
    model.load_state_dict({**written.ema[0], **written.constants})
    del written
    save_weights(model, tmp / "posthoc.pt", "imagenet512")
    del model
    direct = generate(str(tmp / "direct"), n, 64, n, weights=str(tmp / "posthoc.pt"), **common)
    same_png = all((tmp / "cli" / x.name).read_bytes() == (tmp / "direct" / x.name).read_bytes() for x in pngs)
    equal = np.array_equal(from_ckpt["samples"], direct["samples"])
    if len(pngs) != n or not same_png or not equal or not np.isfinite(direct["samples"]).all():
        fail(f"generate --ckpt_path <post-hoc> --load_ema: {len(pngs)} PNGs, PNGs equal {same_png}, samples equal "
             f"{equal}")
    torch.cuda.empty_cache()
    print(f"[27 posthoc] generate --ckpt_path <post-hoc> --load_ema --num_classes 1000 --num_channels 4: {len(pngs)} "
          f"RGBA PNGs, samples equal bit for bit to generate() from the same tree as a weights file "
          f"({from_ckpt['img_per_s']:.2f} img/s Heun-32 at batch {n}) | {smi}", flush=True)


def _write_cifar_checkpoint(directory: Path) -> None:
    """A checkpoint of cifar10.yaml's spec with the seeded full-width model
    (gain_out 1) as params and EMA."""
    from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, load_config
    from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
    from tinyedm_tpu_torch.training.train_step import init_train_state

    spec = instantiate(load_config(ROOT / "experiments" / "conf" / "cifar10.yaml")["model"])
    model = _seeded("cifar10")
    state = init_train_state(model, spec.build_optimizer_config(), spec.build_ema_config())
    CheckpointManager(directory, max_to_keep=None, monitor=None).save(0, state, config={"model": deinstantiate(spec)})


def _features_per_s(fn, images) -> float:
    fn(images[: len(images) // 4])  # warm-up
    t0 = time.perf_counter()
    fn(images)  # the features reach the host: the card is done
    return len(images) / (time.perf_counter() - t0)


def phase_fid(smi: str) -> None:
    """FID on CIFAR-10 with seeded rehearsal Inception weights and proxy
    features (docstring, phase 28)."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch import eval_fid
    from tinyedm_tpu_torch.utils import fid
    from tinyedm_tpu_torch.utils import inception

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        weights = tmp / "inception_v3_pool3.npz"
        inception.save_converted(inception.convert_torch_inception(inception.random_torch_state_dict(0)), weights,
                                 pretrained=False)
        default, inception.DEFAULT_WEIGHTS = inception.DEFAULT_WEIGHTS, weights
        try:
            # (b) the card against the CPU, fp32 without TF32
            imgs = np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
            card = inception.inception_feature_fn(weights, allow_unverified=True)
            on_card, on_cpu = card(imgs), inception.inception_feature_fn(weights, allow_unverified=True,
                                                                        device="cpu")(imgs)
            err = rel_l2(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
            rms = float(np.sqrt(np.mean(on_cpu.astype(np.float64) ** 2)))
            if not (err <= 1e-4 and rms > 0.1):
                fail(f"Inception features on the card vs the CPU: rel L2 {err} (<= 1e-4), RMS {rms}")
            many = np.random.default_rng(1).integers(0, 256, (1024, 32, 32, 3), dtype=np.uint8)
            rates = {b: _features_per_s(inception.inception_feature_fn(weights, batch=b, allow_unverified=True), many)
                     for b in INCEPTION_BATCHES}
            print(f"[28 fid] rehearsal InceptionV3 (seeded He-scale weights, random BN statistics, not pretrained): "
                  f"16 images on the card vs the CPU, fp32 without TF32, rel L2 {err:.3g} (<= 1e-4), feature RMS "
                  f"{rms:.3f}; feature extraction of 1024 32x32 images (resize to 299 included) "
                  + ", ".join(f"{r:.1f} img/s at batch {b}" for b, r in rates.items()), flush=True)

            # (c) stats, then score a checkpoint's samples with both kinds of features
            _write_cifar10(tmp / "cifar10")
            _write_cifar_checkpoint(tmp / "ckpt")
            stats = {}
            for kind in ("proxy", "inception-unverified"):
                stats[kind] = tmp / f"{kind}.npz"
                t0 = time.perf_counter()
                eval_fid.main(["stats", "--data-dir", str(tmp / "cifar10"), "--out", str(stats[kind]), "--features",
                               kind, "--kid-features", str(FID_SAMPLES)])
                print(f"[28 fid]   eval_fid stats --features {kind}: {5 * LOOP_TRAIN_BATCH} images in "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
            samples = tmp / "samples"
            score = ["score", "--ckpt_path", str(tmp / "ckpt"), "--load_ema", "--num_samples", str(FID_SAMPLES),
                     "--batch_size", str(FID_BATCH), "--kid", "--kid_subsets", str(FID_KID_SUBSETS), "--sample_dir",
                     str(samples)]
            results = {}
            for kind in ("proxy", "inception-unverified"):
                t0 = time.perf_counter()
                extra = [] if kind == "proxy" else ["--skip_generate"]  # the first run writes the samples
                results[kind] = eval_fid.main([*score, "--stats", str(stats[kind]), "--features", kind, *extra])
                results[kind]["seconds"] = time.perf_counter() - t0
            try:  # (a) the default features refuse a rehearsal weight file
                eval_fid.main([*score, "--stats", str(stats["proxy"]), "--skip_generate"])
                fail("eval_fid score without --features inception-unverified accepted rehearsal weights")
            except inception.UnverifiedInceptionWeights:
                pass
            for kind, res in results.items():
                fn, _ = fid.resolve_feature_fn(kind)
                same = fid.fid_between_dirs(samples, samples, fn)
                trace = float(np.trace(fid.load_stats(stats[kind])[1]))
                if not (math.isfinite(res["fid"]) and math.isfinite(res["kid"]) and same <= 1e-9 * trace):
                    fail(f"eval_fid score --features {kind}: FID {res['fid']}, KID {res['kid']}, FID(dir, dir) {same} "
                         f"(<= 1e-9 x {trace})")
                print(f"[28 fid] eval_fid score --features {kind} (NOT an Inception FID): {FID_SAMPLES} Heun-32 "
                      f"samples of a seeded cifar10 checkpoint at batch {FID_BATCH}: FID {res['fid']:.4f}, KID "
                      f"{res['kid']:.6f} ({FID_KID_SUBSETS} subsets); FID(dir, same dir) {same:.3g} (<= 1e-9 x trace "
                      f"{trace:.4g}); {res['seconds']:.3f} s in all"
                      + (f" ({FID_SAMPLES / res['seconds']:.2f} img/s, sampling included)" if kind == "proxy" else
                         f", scoring the written PNGs {res['score_seconds']:.3f} s"), flush=True)
            print("[28 fid] eval_fid score without --features inception-unverified: UnverifiedInceptionWeights, as "
                  "required", flush=True)

            # (d) a CIFAR-10 loop with FIDCallback on proxy features
            cb = "callbacks.fid_callback"
            run = tmp / "run"
            _, _, fit_s = _run_train([
                "--config-name=cifar10", f"--config-path={ROOT / 'experiments' / 'conf'}",
                f"datamodule.data_dir={tmp / 'cifar10'}", f"trainer.out_dir={run}", "trainer.max_epochs=1",
                "callbacks.generate_callback=null", f"{cb}._target_=tinyedm_tpu.training.callbacks.FIDCallback",
                f"{cb}.img_shape=[3, 32, 32]", f"{cb}.stats_path={stats['proxy']}",
                f"{cb}.num_samples={FID_CALLBACK_SAMPLES}", f"{cb}.batch_size={FID_BATCH}", f"{cb}.every_n_epochs=1",
                f"{cb}.features=proxy", f"{cb}.solver._target_=tinyedm_tpu.diffusion.solver.DeterministicSolver",
                f"{cb}.solver.num_steps=32"], "28 fid")
            rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            fid_rows = [r for r in rows if "fid" in r]
            if len(fid_rows) != 1 or not math.isfinite(fid_rows[0]["fid"]):
                fail(f"FIDCallback: fid rows {fid_rows}")
            torch.cuda.empty_cache()
            print(f"[28 fid] cifar10.yaml, 1 epoch, with FIDCallback (proxy features, {FID_CALLBACK_SAMPLES} "
                  f"Heun-32 samples at batch {FID_BATCH}): logged fid {fid_rows[0]['fid']:.4f} at step "
                  f"{fid_rows[0]['step']}; {fit_s:.3f} s in all | {smi}", flush=True)
        finally:
            inception.DEFAULT_WEIGHTS = default


# ---------------------------------------------------------------------------
# phases 29-31: the latent pipeline (the SD VAE, extraction, decoded previews)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _hf_home(path: Path):
    """``$HF_HOME`` set to ``path`` while active (the VAE's lookup reads it)."""
    import os

    old = os.environ.get("HF_HOME")
    os.environ["HF_HOME"] = str(path)
    try:
        yield
    finally:
        if old is None:
            del os.environ["HF_HOME"]
        else:
            os.environ["HF_HOME"] = old


def write_vae_files(tmp: Path) -> dict:
    """The seeded random sd-vae weights (VAE_SEED) as a fake Hugging Face
    cache under ``tmp/hf`` (``diffusion_pytorch_model.safetensors``, written
    by the port's own writer, in a snapshot that ``refs/main`` names) and as
    ``tmp/vae.bin`` (``torch.save``); returns the paths and the seconds."""
    import torch

    from tinyedm_tpu_torch.data.vae import random_state_dict
    from tinyedm_tpu_torch.utils.safetensors import save_safetensors

    t0 = time.perf_counter()
    sd = random_state_dict(VAE_SEED)
    repo = tmp / "hf" / "hub" / "models--stabilityai--sd-vae-ft-ema"
    snapshot = repo / "snapshots" / "0123456789abcdef"
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123456789abcdef")
    save_safetensors(sd, snapshot / "diffusion_pytorch_model.safetensors", metadata={"format": "pt"})
    torch.save(sd, tmp / "vae.bin")
    return dict(hf_home=tmp / "hf", bin=tmp / "vae.bin", seconds=time.perf_counter() - t0,
                mb=(snapshot / "diffusion_pytorch_model.safetensors").stat().st_size / 1e6)


def _vae_flops(method: str, shape: tuple) -> int:
    """Multiply-adds x 2 of one ``AutoencoderKL`` call at ``shape``: every
    conv and projection from its output's size, plus the two attention
    products, counted on the meta device."""
    import torch

    from tinyedm_tpu_torch.data import vae as V

    with torch.device("meta"):
        model = V.AutoencoderKL()
    total = [0]

    def conv(mod, _, out):
        total[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    def linear(mod, _, out):
        total[0] += 2 * out.numel() * mod.in_features

    def attn(_, args, out):
        b, c, h, w = args[0].shape
        total[0] += 2 * 2 * b * (h * w) ** 2 * c

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(linear)
        elif isinstance(m, V.AttnBlock):
            m.register_forward_hook(attn)
    with torch.no_grad():
        getattr(model, method)(torch.empty(shape, device="meta"))
    return total[0]


def _peak_gib(fn) -> tuple[float, object]:
    """(GiB the call allocated above what was live before it, its result)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30, out


def phase_vae(smi: str, files: dict) -> None:
    """The SD VAE at full sd-vae-ft-ema width (docstring, phase 29)."""
    import torch

    from tinyedm_tpu_torch.data import vae as V
    from tinyedm_tpu_torch.utils.cuda import set_precision

    # loading: from the fake HF cache by the default name, and from a .bin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _hf_home(files["hf_home"]):
        where = V.find_vae_weights(V.DEFAULT_VAE)
        vae = V.load_vae(V.DEFAULT_VAE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    from_bin = V.load_vae(str(files["bin"]))
    ref = V.random_state_dict(VAE_SEED)
    sd, sd_bin = vae.state_dict(), from_bin.state_dict()
    n_params = sum(t.numel() for t in sd.values())
    if not (set(sd) == set(ref) == set(sd_bin) and all(torch.equal(sd[k].cpu(), ref[k]) for k in ref)
            and all(torch.equal(sd_bin[k].cpu(), ref[k]) for k in ref)):
        fail("load_vae: the weights read from the HF cache or the .bin differ from the seeded state dict")
    if n_params != VAE_PARAMS or where.parent.name != "0123456789abcdef" or where.suffix != ".safetensors":
        fail(f"load_vae: {n_params} parameters (expected {VAE_PARAMS}), resolved to {where}")
    del from_bin, sd_bin
    print(f"[29 vae] {V.DEFAULT_VAE} resolved in the HF cache at {where.relative_to(files['hf_home'])} "
          f"({files['mb']:.1f} MB, written by the port's safetensors writer in {files['seconds']:.3f} s with the "
          f".bin) and loaded to the card in {load_s:.3f} s; the .bin through load_vae too: both equal to the seeded "
          f"state dict, {n_params} parameters", flush=True)

    # the card against the CPU, fp32 (TF32 off on the card)
    g = torch.Generator().manual_seed(VAE_SEED + 1)
    x = torch.rand((1, 3, VAE_CPU_SIDE, VAE_CPU_SIDE), generator=g) * 2 - 1
    cpu = V.build_vae(ref, "cpu")
    with torch.no_grad():
        t0 = time.perf_counter()
        mean0, logvar0 = cpu.encode_moments(x)
        dec0 = cpu.decode(mean0)
        cpu_s = time.perf_counter() - t0
        mean1, logvar1 = vae.encode_moments(x.cuda())
        dec1 = vae.decode(mean0.cuda())
    errs = [rel_l2(a.cpu(), b) for a, b in ((mean1, mean0), (logvar1, logvar0), (dec1, dec0))]
    if not all(e <= VAE_TOL for e in errs) or not all(torch.isfinite(t).all() for t in (mean1, logvar1, dec1)):
        fail(f"VAE card vs CPU at {VAE_CPU_SIDE}x{VAE_CPU_SIDE}: rel L2 mean/logvar/decode {errs} (> {VAE_TOL})")
    del cpu
    print(f"[29 vae] card vs CPU (fp32, TF32 off) on a {VAE_CPU_SIDE}x{VAE_CPU_SIDE} image and its "
          f"{VAE_CPU_SIDE // 8}x{VAE_CPU_SIDE // 8} latent: rel L2 mean {errs[0]:.3g}, logvar {errs[1]:.3g}, decode "
          f"{errs[2]:.3g} (<= {VAE_TOL}); the CPU took {cpu_s:.3f} s", flush=True)

    # throughput and peak memory at the pipeline's batches
    numbers = {}
    b, side = VAE_ENCODE
    xb = torch.rand((b, 3, side, side), device="cuda") * 2 - 1
    with torch.no_grad():
        gib, _ = _peak_gib(lambda: vae.encode_moments(xb))
        ms = time_ms(lambda: vae.encode_moments(xb), iters=1, reps=3)
        flops = _vae_flops("encode_moments", (b, 3, side, side))
        numbers["encode"] = dict(batch=b, ms=ms, gib=gib, flops=flops)
        del xb
        for b in VAE_DECODES:
            z = torch.randn((b, 4, 64, 64), device="cuda")
            gib, out = _peak_gib(lambda: vae.decode(z))
            if out.shape != (b, 3, 512, 512) or not torch.isfinite(out).all():
                fail(f"VAE decode of {b}: {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
            del out
            ms = time_ms(lambda: vae.decode(z), iters=1, reps=1 if b > 32 else 2)
            numbers[f"decode{b}"] = dict(batch=b, ms=ms, gib=gib, flops=_vae_flops("decode", (b, 4, 64, 64)))
            del z
        for name, side_attn, b, key in (("encoder", 64, VAE_ENCODE[0], "encode"),
                                        ("decoder", 64, VAE_DECODES[0], f"decode{VAE_DECODES[0]}")):
            block = getattr(vae, name).mid_block.attentions[0]
            h = torch.randn((b, 512, side_attn, side_attn), device="cuda")
            numbers[key]["attn_ms"] = time_ms(lambda: block(h.clone()), iters=2, reps=3)
            del h
        # the open question of PERF.md section 7: the decode of 32 in bf16
        # and with TF32, against fp32 (no gate)
        z = torch.randn((VAE_DECODES[0], 4, 64, 64), device="cuda")
        ref32 = vae.decode(z)
        bf16 = V.build_vae(ref, "cuda", dtype=torch.bfloat16)
        variants = {"bf16": (time_ms(lambda: bf16.decode(z), iters=1, reps=2), rel_l2(bf16.decode(z).float(), ref32))}
        del bf16
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            variants["tf32"] = (time_ms(lambda: vae.decode(z), iters=1, reps=2), rel_l2(vae.decode(z), ref32))
        finally:
            set_precision()
        del z, ref32
    torch.cuda.empty_cache()
    for key, r in numbers.items():
        what = "encode_moments" if key == "encode" else "decode"
        shape = f"{r['batch']} images at 512x512" if key == "encode" else f"{r['batch']} latents at 64x64"
        bound = 1e3 * r["flops"] / PEAK_FLOPS["float32"]
        attn = (f"; the mid-block attention alone (one head of 512 over 4096 tokens) {r['attn_ms']:.2f} ms, "
                f"{r['attn_ms'] / r['ms']:.4f} of it") if "attn_ms" in r else ""
        print(f"[29 vae] {what} of {shape}, fp32: {r['ms']:.1f} ms, {1e3 * r['batch'] / r['ms']:.2f} img/s, "
              f"{r['ms'] / r['batch']:.2f} ms/img, {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s achieved "
              f"({r['flops'] / r['batch'] / 1e12:.3f} TFLOP/img; fp32 bound {bound / r['batch']:.2f} ms/img at 67 "
              f"TFLOP/s, {bound / r['ms']:.3f} of it); peak {r['gib']:.2f} GiB above the weights{attn} | {smi}",
              flush=True)
    fp32_ms = numbers[f"decode{VAE_DECODES[0]}"]["ms"]
    print(f"[29 vae] decode of {VAE_DECODES[0]} in other arithmetic (no gate): "
          + "; ".join(f"{k} {ms:.1f} ms ({fp32_ms / ms:.2f}x fp32's speed), rel L2 to fp32 {err:.3g}"
                      for k, (ms, err) in variants.items()) + f" | {smi}", flush=True)
    del vae
    torch.cuda.empty_cache()


def _structured_image(h: int, w: int, channels: int, seed: int):
    """Smooth gradients, a disc and mild noise, uint8 HWC (HW for 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 3) ** 2) * 60.0
    planes = [128 + 90 * np.sin(xx / (37 + 11 * c) + yy / (53 + 7 * c)) + disc for c in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0, 4, (h, w, channels)).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _write_image_folder(root: Path) -> list[Path]:
    """EXTRACT_PNGS written with the port's PNG writer (two classes), plus
    the committed JPEG fixtures; returns the JPEGs."""
    import numpy as np

    from tinyedm_tpu_torch.training.callbacks import encode_png

    for i, (cls, name, mode, h, w) in enumerate(EXTRACT_PNGS):
        (root / cls).mkdir(parents=True, exist_ok=True)
        if mode == "P":
            rgb = _structured_image(h, w, 3, seed=i)
            palette = np.unique(rgb.reshape(-1, 3) // 32 * 32 + 16, axis=0)[:256].astype(np.uint8)
            idx = np.random.default_rng(i).integers(0, len(palette), (h, w)).astype(np.uint8)
            data = encode_png(idx, palette=palette)
        else:
            data = encode_png(_structured_image(h, w, {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode], seed=i))
        (root / cls / f"{name}.png").write_bytes(data)
    jpegs = []
    for cls, name in EXTRACT_JPEGS:
        dst = root / cls / f"{name}.jpg"
        shutil.copyfile(JPEG_FIXTURES / f"{name}.jpg", dst)
        jpegs.append(dst)
    return jpegs


def phase_jpeg(smi: str) -> None:
    """nvJPEG against the committed PIL decodes (docstring, phase 30)."""
    import numpy as np

    from tinyedm_tpu_torch.data.images import JpegDecoder, read_image

    dec = JpegDecoder("cuda")
    try:
        for name in JPEG_READ:
            path = JPEG_FIXTURES / f"{name}.jpg"
            got = read_image(path, dec).pixels
            ref = np.load(JPEG_FIXTURES / f"{name}.npy")
            if got.shape != ref.shape or got.dtype != np.uint8:
                fail(f"nvJPEG {name}.jpg: {got.dtype} {got.shape}, PIL {ref.shape}")
            diff = np.abs(got.astype(np.int16) - ref)
            if not diff.mean() <= JPEG_MEAN_TOL:
                fail(f"nvJPEG {name}.jpg vs PIL: mean abs {diff.mean():.4f} > {JPEG_MEAN_TOL} (max {diff.max()})")
            print(f"[30 extract] nvJPEG {name}.jpg {ref.shape[1]}x{ref.shape[0]} vs PIL's decode: mean abs "
                  f"{diff.mean():.4f} (<= {JPEG_MEAN_TOL}), max abs {diff.max()}", flush=True)
        # a JPEG whose SOF says 2 components, made in memory from a fixture
        data = bytearray((JPEG_FIXTURES / "rgb444.jpg").read_bytes())
        i = 2
        while data[i + 1] not in (0xC0, 0xC1, 0xC2):
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
        data[i + 9] = 2  # marker, length, precision, height, width, then the component count
        with tempfile.TemporaryDirectory() as tmp:
            bad = Path(tmp) / "two_components.jpg"
            bad.write_bytes(bytes(data))
            try:
                read_image(bad, dec)
            except ValueError as e:
                if bad.name not in str(e):
                    fail(f"the refusal of {bad.name} does not name it: {e}")
                print(f"[30 extract] {bad.name} (the SOF of rgb444.jpg set to 2 components) refused: {e}",
                      flush=True)
            else:
                fail(f"{bad.name} was decoded; a 2-component JPEG must raise")
    finally:
        dec.close()


def phase_extract(smi: str, files: dict, tmp: Path) -> None:
    """Latent extraction through the CLI at 512, then the latpack CLI and
    PackedLatentsDataModule (docstring, phase 30)."""
    import numpy as np

    from tinyedm_tpu_torch.data import extract_latents, latpack
    from tinyedm_tpu_torch.data.latpack import PackedLatentsDataModule

    phase_jpeg(smi)
    folder, out = tmp / "folder", tmp / "latents"
    _write_image_folder(folder)
    n_files = len(EXTRACT_PNGS) + len(EXTRACT_JPEGS)
    io_out = io.StringIO()
    with _hf_home(files["hf_home"]), contextlib.redirect_stdout(io_out):
        written = extract_latents.main(["--data-dir", str(folder), "--out-dir", str(out), "--image-size",
                                        str(EXTRACT_SIZE), "--batch-size", str(EXTRACT_BATCH)])
    for line in io_out.getvalue().splitlines():
        print(f"[30 extract]   {line}", flush=True)
    summary = io_out.getvalue().strip().splitlines()[-1]
    names = sorted(p.name for p in (out / "latents").iterdir())
    want = sorted(f"{i}.npy" for i in range(2 * n_files))
    if written != 2 * n_files or names != want or sorted(p.name for p in (out / "labels").iterdir()) != want:
        fail(f"extract_latents wrote {written} samples, files {names[:5]}..., expected {2 * n_files}")
    classes = sorted({cls for cls, *_ in EXTRACT_PNGS} | {cls for cls, _ in EXTRACT_JPEGS})
    per_class = [sum(1 for c, *_ in EXTRACT_PNGS if c == cls) + sum(1 for c, _ in EXTRACT_JPEGS if c == cls)
                 for cls in classes]
    want_labels = [ci for ci, k in enumerate(per_class) for _ in range(k)] * 2
    lats = [np.load(out / "latents" / f"{i}.npy") for i in range(written)]
    labels = [int(np.load(out / "labels" / f"{i}.npy")) for i in range(written)]
    side = EXTRACT_SIZE // 8
    if (labels != want_labels or any(a.shape != (side, side, 4) or a.dtype != np.float32 for a in lats)
            or not all(np.isfinite(a).all() for a in lats)):
        fail(f"extract_latents: labels {labels} (expected {want_labels}), shapes {sorted({a.shape for a in lats})}")
    store = tmp / "extracted.latpack"
    io_out = io.StringIO()
    with contextlib.redirect_stdout(io_out):
        latpack.main([str(out / "latents"), str(out / "labels"), str(store)])
    dm = PackedLatentsDataModule(batch_size=EXTRACT_BATCH, data_file=str(store), val_fraction=0.1, prefetch=False)
    dm.setup()
    try:
        batch, blabels, *_ = next(iter(dm.train_batches(0)))
        got, glab = dm._require().gather(np.arange(written))
    finally:
        dm._require().close()
    if (batch.shape != (EXTRACT_BATCH, side, side, 4) or not np.array_equal(got, np.stack(lats))
            or not np.array_equal(glab, labels)):
        fail(f"latpack of the extracted latents: batch {batch.shape}, gather equal to the files "
             f"{np.array_equal(got, np.stack(lats))}")
    print(f"[30 extract] python -m tinyedm_tpu_torch.data.extract_latents --image-size {EXTRACT_SIZE} --batch-size "
          f"{EXTRACT_BATCH} (flips on) over {n_files} files ({len(EXTRACT_PNGS)} PNGs written by the port: RGB, L, "
          f"LA, RGBA, P, short sides {min(min(h, w) for *_, h, w in EXTRACT_PNGS)} to "
          f"{max(min(h, w) for *_, h, w in EXTRACT_PNGS)}, the BOX path from 1024; {len(EXTRACT_JPEGS)} JPEG "
          f"fixtures): {written} HWC float32 latents {side}x{side}x4 and labels {sorted(set(labels))}, named "
          f"0..{written - 1}; {io_out.getvalue().strip()}; PackedLatentsDataModule batch {tuple(batch.shape)}, the "
          f"store equal to the files bit for bit | {smi}", flush=True)
    print(f"[30 extract] {summary}", flush=True)


def phase_preview(smi: str, trainer, run_output: str, grids: list) -> None:
    """The decoded latent preview of phase 26's run (docstring, phase 31)."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch.training.callbacks import DECODE_BATCH, LatentsGenerateCallback, read_png

    cb = next((c for c in trainer.callbacks if isinstance(c, LatentsGenerateCallback)), None)
    if cb is None or cb._vae is None or "VAE unavailable" in run_output:
        fail("imagenet512.yaml's LatentsGenerateCallback did not load the VAE from the HF cache "
             f"({'warned' if 'VAE unavailable' in run_output else 'no warning'})")
    n = cb.num_samples_per_class * cb.num_classes
    rows = n // cb.num_classes
    shape = (rows * 514 + 2, cb.num_classes * 514 + 2, 3)
    for g in grids:
        img = read_png(g)
        if img.shape != shape:
            fail(f"preview grid {g.name}: {img.shape}, expected {shape} ({rows} x {cb.num_classes} of 512x512)")
    _clear_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cb.on_validation_end(trainer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _kernel_calls()
    calls = PATHS["imagenet512"]["calls"]
    expected = {("fwd", k): IN512_PREVIEW[1] * c for k, c in calls.items()}
    if counts != expected:
        fail(f"the preview's Heun-32 solve launched {counts}, expected {expected}")
    latest = sorted((trainer.logger.out_dir / "images").glob("Generated_*.png"))[-1]
    img = read_png(latest)
    if img.shape != shape or not (img.std() > 0):
        fail(f"the decoded preview grid {latest.name}: {img.shape}, std {img.std()}")
    print(f"[31 preview] imagenet512.yaml's LatentsGenerateCallback in phase 26's run: the VAE found by its default "
          f"name ({cb.vae_name}) in the HF cache, no 'VAE unavailable' warning, {len(grids)} decoded grids of "
          f"{rows} x {cb.num_classes} images of 512x512 ({shape[1]}x{shape[0]} PNGs)", flush=True)
    print(f"[31 preview] one more preview on the trained state: {seconds:.3f} s in all (Heun-32 at batch {n}: "
          f"{IN512_PREVIEW[1]} forwards, fused launches {_fmt(counts)}), the decode of {n} latents "
          f"{cb.last_decode_seconds:.3f} s ({n / cb.last_decode_seconds:.2f} img/s, in chunks of "
          f"{DECODE_BATCH}); peak {peak / 2**30:.3f} GiB with the training state "
          f"({base / 2**30:.3f} GiB live before it) | {smi}", flush=True)


def _block_inputs(b, n, c, dtype, seed):
    """x, the effective weights wqkv and wout (unit-RMS rows / sqrt(C), as
    weight normalization leaves them), and a cotangent g."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, c), generator=gen, device="cuda").to(dtype)
    wq = (torch.randn((c, 3 * c), generator=gen, device="cuda") / c**0.5).to(dtype)
    wo = (torch.randn((c, c), generator=gen, device="cuda") / c**0.5).to(dtype)
    g = (torch.randn((b, n, c), generator=gen, device="cuda") * 0.5).to(dtype)
    return x, wq, wo, g


def _check_block_fwd(out, ref, dtype_name: str, what: str) -> tuple[float, float, float]:
    """A block forward's output against the plain version's: (max abs,
    relative L2, largest difference in bf16 ulps of max(1, |ref|)). fp32:
    atol = rtol = 1e-5. bf16: phase 4's relative L2 of 1e-3 and, element by
    element, three bf16 ulps (2.4e-2 of max(1, |ref|)): the GEMMs' fp32
    sums, taken in another order than cuBLAS's, can round T(qkv) and T(out)
    to their neighbours, and the residual's four bf16 roundings (out - x,
    * t, x + ., * s) carry one ulp of out into up to two ulps of the output."""
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"block fwd {what}: non-finite kernel output")
    diff = (out.float() - ref.float()).abs()
    err, rel = float(diff.max()), rel_l2(out, ref)
    ulps = float((diff / ref.float().abs().clamp(min=1.0)).max()) / 2.0**-7
    if dtype_name == "float32":
        _check(out, ref, dtype_name, f"block fwd {what}")
    elif not (rel <= BWD_TOL[dtype_name] and ulps <= 3):
        fail(f"block fwd {what}: rel L2 {rel} (<= {BWD_TOL[dtype_name]}), max abs {err}, "
             f"{ulps} bf16 ulps of max(1, |ref|) (<= 3)")
    return err, rel, ulps


def _check_block(x, wq, wo, g, heads: int, dtype_name: str, what: str) -> tuple[tuple, float, float]:
    """Both block kernels against the plain versions: (the forward's max abs,
    relative L2 and ulps, within _check_block_fwd's gates; the backward's max
    abs over dx, dWqkv and dWout; their worst relative L2)."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    out = fa.attention_block_cuda(x, wq, wo, heads)
    torch.cuda.synchronize()
    fwd = _check_block_fwd(out, fa.attention_block_plain(x, wq, wo, heads), dtype_name, what)
    grads = fa.attention_block_bwd_cuda(x, wq, wo, g, heads)
    torch.cuda.synchronize()
    refs = fa.attention_block_bwd_plain(x, wq, wo, g, heads)
    errs = [_check_bwd(d, r, dtype_name, f"block bwd {what} {label}")
            for d, r, label in zip(grads, refs, ("dx", "dwqkv", "dwout"))]
    return fwd, max(e for e, _ in errs), max(r for _, r in errs)


def _split_route(x, wq, wo, heads: int):
    """The block as the fused="auto" layer computes it: cuBLAS GEMMs around
    the fused attention kernels (phases 3-4). Returns (forward, backward)
    callables; the backward takes the forward's saved qkv and y, as autograd
    would, and returns dx, dWqkv and dWout."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import in_dtype, mp_add

    b, n, c = x.shape
    ts = in_dtype(0.5 / (0.5**0.5), x.dtype)

    def forward():
        qkv = torch.matmul(x, wq)
        y = fa.cosine_attention_qkv_cuda(qkv, heads)
        return mp_add(x, torch.matmul(y, wo), 0.5), qkv, y

    def backward(g, qkv, y):
        gout = g * ts
        dwo = torch.matmul(y.reshape(b * n, c).t(), gout.reshape(b * n, c))
        dqkv = fa.cosine_attention_qkv_bwd_cuda(qkv, torch.matmul(gout, wo.t()), y, heads)
        dwq = torch.matmul(x.reshape(b * n, c).t(), dqkv.reshape(b * n, 3 * c))
        return torch.matmul(dqkv, wq.t()) + gout, dwq, dwo

    return forward, backward


def phase_block_kernels() -> list[dict]:
    """The whole-block kernels against their plain versions; times at the
    CIFAR-10 attention widths of the kernels, the plain versions and the
    split route on the same inputs. No single PyTorch call computes the
    block, so library_ms is null and the split route's time stands beside."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    entries = []
    for direction, b, n in BLOCK_SHAPES:
        c = BLOCK_C
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x, wq, wo, g = _block_inputs(b, n, c, dtype, seed=n + b)
            (fwd_err, fwd_rel, fwd_ulps), bwd_err, bwd_rel = _check_block(x, wq, wo, g, HEADS, name,
                                                                          f"b={b} n={n} {name}")
            print(f"[13 block vs plain] b={b} n={n} C={c} heads={HEADS} {name}: forward max_abs "
                  f"{fwd_err:.3g} rel_l2 {fwd_rel:.3g} ({fwd_ulps:.3g} bf16 ulps of max(1, |ref|)), backward "
                  f"max_abs {bwd_err:.3g} worst rel_l2 {bwd_rel:.3g}", flush=True)
            if dtype != torch.bfloat16:  # times in the main path's type
                continue
            split_fwd, split_bwd = _split_route(x, wq, wo, HEADS)
            itemsize = x.element_size()
            if direction == "fwd":
                ms = time_ms(lambda: fa.attention_block_cuda(x, wq, wo, HEADS), iters=5, reps=3)
                plain_ms = time_ms(lambda: fa.attention_block_plain(x, wq, wo, HEADS), iters=3, reps=3)
                split_ms = time_ms(split_fwd, iters=5, reps=3)
                nbytes = (2 * b * n * c + 4 * c * c) * itemsize
                flops = b * n * c * 4 * c * 2 + 4 * b * n * n * c + 4 * b * n * c
                err = fwd_err
            else:
                _, qkv, y = split_fwd()
                ms = time_ms(lambda: fa.attention_block_bwd_cuda(x, wq, wo, g, HEADS), iters=3, reps=3)
                plain_ms = time_ms(lambda: fa.attention_block_bwd_plain(x, wq, wo, g, HEADS),
                                   iters=2, reps=3)
                split_ms = time_ms(lambda: split_bwd(g, qkv, y), iters=3, reps=3)
                nbytes = 3 * b * n * c * itemsize + 4 * c * c * (itemsize + 4)
                # 11 GEMMs of m c^2 multiply-adds (the qkv recompute 3, dy 1,
                # dx 3, dWout 1, dWqkv 3) and six of the attention's
                # products (S, y = P V for dWout, dP, dq, dk, dv)
                flops = 2 * 11 * b * n * c * c + 12 * b * n * n * c
                err = bwd_err
                del qkv, y
            bound_ms, bound_by = _bound(nbytes, flops, name)
            print(f"[13 block vs plain] attention_block_{direction} b={b} n={n} {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, split route (cuBLAS + fused kernels) {split_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
            entries.append(_entry(
                f"attention_block_{direction}[cifar10 b={b} n={n}]", f"attention_block_{direction}.cu",
                BLOCK_REPLACES[direction], err, ms, plain_ms, bound_ms, bound_by, None,
                split_ms=split_ms, n=n))
            del x, wq, wo, g
            torch.cuda.empty_cache()
    worst = (0.0, 0.0)  # the bf16 forward's largest relative L2 and ulps
    for b, n, heads, c in BLOCK_ODD:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            (_, rel, ulps), _, _ = _check_block(*_block_inputs(b, n, c, dtype, seed=b * n + c), heads, name,
                                                f"b={b} n={n} heads={heads} C={c} {name}")
            if dtype == torch.bfloat16:
                worst = (max(worst[0], rel), max(worst[1], ulps))
    print("[13 block vs plain] odd shapes (n = 1, 49, 50, 64, 300; heads 1, 3, 4; C = 20, 64, 96, 192, 256, "
          f"288, 768): ok; bf16 forward at most rel_l2 {worst[0]:.3g}, {worst[1]:.3g} ulps", flush=True)
    return entries


def _kernel_calls() -> dict:
    from tinyedm_tpu_torch.ops import fused_attention as fa

    return {k: v for k, v in fa.launch_counts.items() if v}


def phase_block_layer() -> None:
    """CosineAttention(fused="block") against fused="off" on the same
    weights, forward and backward, where block_kernel_fits holds (C = 256)
    and where it does not (C = 768: the unfused route, no kernel call)."""
    import torch

    from tinyedm_tpu_torch.models.edm import init_weights
    from tinyedm_tpu_torch.models.layers import CosineAttention
    from tinyedm_tpu_torch.ops.fused_attention import block_kernel_fits

    for b, c, side in BLOCK_LAYERS:
        n = side * side
        block = CosineAttention(c, HEADS, dtype=torch.bfloat16, fused="block")
        init_weights(block, torch.Generator().manual_seed(c))
        block = block.cuda()
        ref = CosineAttention(c, HEADS, dtype=torch.bfloat16, fused="off").cuda()
        ref.load_state_dict(block.state_dict())
        gen = torch.Generator(device="cuda").manual_seed(side)
        x = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        results = []
        for module in (block, ref):
            xr = x.clone().requires_grad_(True)
            _clear_counts()
            out = module(xr)
            (dx,) = torch.autograd.grad(out, xr, g)
            torch.cuda.synchronize()
            results.append((out.detach(), dx, {**_kernel_calls(), **_flash_calls()}))
        (out, dx, counts), (rout, rdx, rcounts) = results
        fits = block_kernel_fits(n, c, HEADS)
        expected = {("block_fwd", n): 1, ("block_bwd", n): 1} if fits else {}
        if fits != (c == 256) or counts != expected or rcounts:
            fail(f"block layer C={c} n={n} (fits {fits}) launched {counts} (reference {rcounts}), "
                 f"expected {expected}")
        if not (torch.isfinite(out.float()).all() and torch.isfinite(dx.float()).all()):
            fail(f"block layer C={c}: non-finite output or gradient")
        out_err, dx_err = rel_l2(out, rout), rel_l2(dx, rdx)
        route = "the block kernels" if fits else "the unfused route (block_kernel_fits is false)"
        print(f"[14 block layer] CosineAttention({c}, {HEADS} heads, bf16, fused=\"block\") at "
              f"({b}, {c}, {side}, {side}), n={n}: {route}, calls {_fmt(counts) if counts else '{}'}; "
              f"against fused=\"off\" output rel L2 {out_err:.3g} (<= 1e-2), input gradient {dx_err:.3g} "
              f"(<= 2e-2)", flush=True)
        if not (out_err <= 1e-2 and dx_err <= 2e-2):
            fail(f"block layer C={c}: output {out_err} or input gradient {dx_err} off the limits")
        del block, ref, results, out, dx, rout, rdx
        torch.cuda.empty_cache()


def _wino_inputs(b, h, w, ci, co, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, ci), generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, ci, co), generator=gen, device="cuda") / (9 * ci) ** 0.5).to(dtype)
    return x, wt


def _direct_conv(x, w):
    """F.conv2d on the NHWC input and HWIO weight as views (channels_last),
    in their type; NHWC out."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def _check_wino(x, w, dtype_name: str, what: str) -> float:
    """The kernel against the plain version and the fp32 direct conv: its
    max abs difference from the plain version."""
    import torch

    from tinyedm_tpu_torch.ops import winograd as wg

    y = wg.winograd_conv3x3_cuda(x, w)
    torch.cuda.synchronize()
    if not torch.isfinite(y.float()).all():
        fail(f"winograd {what}: non-finite kernel output")
    ref = wg.winograd_conv3x3_plain(x, w)
    direct = _direct_conv(x.float(), w.float())
    err = float((y.float() - ref.float()).abs().max())
    if dtype_name == "float32":
        for r, label in ((ref, "plain"), (direct, "direct conv")):
            torch.testing.assert_close(y, r, atol=2e-5, rtol=2e-5, msg=lambda m: f"winograd {what} vs {label}: {m}")
    else:
        rel_plain, rel_direct = rel_l2(y, ref), rel_l2(y, direct)
        if not (rel_plain <= 1e-3 and rel_direct <= 2e-2):
            fail(f"winograd {what}: rel L2 {rel_plain} to plain (<= 1e-3), {rel_direct} to the direct conv (<= 2e-2)")
    return err


def phase_winograd() -> list[dict]:
    """The Winograd kernel against its plain version and the direct conv,
    its times, then the op's path: winograd_conv3x3 once per CIFAR-10 shape
    with the counts set to 0 just before."""
    import torch

    from tinyedm_tpu_torch.ops import winograd as wg

    entries = []
    for b, side, ci, co in WINO_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x, w = _wino_inputs(b, side, side, ci, co, dtype, seed=side + ci)
            err = _check_wino(x, w, name, f"b={b} {side}x{side} {ci}->{co} {name}")
            if dtype != torch.bfloat16:
                print(f"[17 winograd] b={b} {side}x{side} {ci}->{co} {name}: max_abs to plain {err:.3g}; "
                      f"matches plain and F.conv2d within 2e-5", flush=True)
                continue
            # the op (U transform, then the kernel) and the kernel alone
            ms = time_ms(lambda: wg.winograd_conv3x3_cuda(x, w), iters=10, reps=3)
            kernel_ms = _kernel_ms(lambda: wg.winograd_conv3x3_cuda(x, w), ("winograd_fwd",), calls=10)[0]
            plain_ms = time_ms(lambda: wg.winograd_conv3x3_plain(x, w), iters=3, reps=3)
            library_ms = time_ms(lambda: _direct_conv(x, w), iters=10, reps=3)
            tiles = b * (side // 2) ** 2
            nbytes = (b * side * side * (ci + co) + 16 * ci * co) * x.element_size()  # x, U, y
            flops = 2 * 16 * ci * co * tiles  # the 16 component products
            adds = (32 * ci + 36 * co) * tiles  # B^T d B per input, the A^T folds per output channel
            bound_ms, bound_by = _bound(nbytes, flops, name, adds)
            direct_flops = 2 * b * side * side * 9 * ci * co  # the direct conv's, as winograd.py:184
            direct_ms, _ = _bound(nbytes, direct_flops, name)
            print(f"[17 winograd] b={b} {side}x{side} {ci}->{co} {name}: max_abs to plain {err:.3g} | op (U "
                  f"transform and kernel) {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms; plain {plain_ms:.4f} ms, "
                  f"F.conv2d {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of products, "
                  f"{adds / 1e9:.3f} G fp32 transform adds); the direct conv's {direct_flops / 1e9:.2f} GFLOP "
                  f"would bound it at {direct_ms:.4f} ms", flush=True)
            entries.append(_entry(
                f"winograd_fwd[b={b} {side}x{side} {ci}->{co}]", "winograd_fwd.cu", WINO_REPLACES, err, ms,
                plain_ms, bound_ms, bound_by, library_ms, key=("winograd", side, side, ci, co),
                bound_ms_direct_conv=direct_ms, kernel_ms=kernel_ms))
            del x, w
    worst = {}
    for b, h, w_, ci, co in WINO_ODD:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            err = _check_wino(*_wino_inputs(b, h, w_, ci, co, dtype, seed=h * w_ + ci), name,
                              f"b={b} {h}x{w_} {ci}->{co} {name}")
            worst[name] = max(worst.get(name, 0.0), err)
    # x one element into its storage: not 16-byte aligned, so element loads
    x, w = _wino_inputs(3, 10, 14, 40, 72, torch.bfloat16, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:].copy_(x.reshape(-1))
    _check_wino(flat[1:].view(x.shape), w, "bfloat16", "b=3 10x14 40->72 bfloat16, x at an odd offset")
    print(f"[17 winograd] odd shapes (2x2, 6x6, 4x8, 6x4, 10x14; Ci/Co 3, 20, 24, 40, 72; x at an odd offset): ok; "
          f"largest max_abs to plain "
          f"bf16 {worst['bfloat16']:.3g}, fp32 {worst['float32']:.3g}", flush=True)
    # the op's path: one call per CIFAR-10 conv shape, bf16
    inputs = [_wino_inputs(b, side, side, ci, co, torch.bfloat16, seed=7) for b, side, ci, co in WINO_SHAPES]
    wg.launch_counts.clear()
    outs = [wg.winograd_conv3x3(x, w) for x, w in inputs]
    torch.cuda.synchronize()
    counts = {k: v for k, v in wg.launch_counts.items() if v}
    expected = {("winograd", side, side, ci, co): 1 for _, side, ci, co in WINO_SHAPES}
    if counts != expected:
        fail(f"winograd_conv3x3 at the CIFAR-10 shapes launched {counts}, expected {expected}")
    for (x, _), y, (b, side, ci, co) in zip(inputs, outs, WINO_SHAPES):
        if y.shape != (b, side, side, co) or not torch.isfinite(y.float()).all():
            fail(f"winograd_conv3x3 output {tuple(y.shape)} not finite or not {(b, side, side, co)}")
    print(f"[17 winograd] winograd_conv3x3 at the {len(WINO_SHAPES)} CIFAR-10 shapes: one launch each, "
          "finite outputs of the expected shapes", flush=True)
    for e in entries:
        e["launches"] = counts[e.pop("key")]
        e["path"] = "winograd_conv3x3 at the CIFAR-10 conv shapes"
    return entries


# ---------------------------------------------------------------------------
# phases 32-33: reference (Lightning) checkpoints and the model knobs
# ---------------------------------------------------------------------------

# the full-width models of phase 32 and their YAMLs (the import's config)
REF_CONFIGS = {"cifar10": "cifar10.yaml", "imagenet512": "imagenet512.yaml"}
REF_STEP = 1234
REF_FWD_BATCH = 8
# phase 33: the remat forms, the knobs' train steps (warm-up, timed) and the
# fused="on" layer shapes (batch, channels, side): n = 1024 and the odd 961
REMAT_FORMS = {"off": {}, "full": dict(remat=True, remat_policy="full"),
               "convs": dict(remat=True, remat_policy="convs")}
KNOB_STEPS = (1, 3)
ON_LAYERS = [(8, 256, 32), (8, 256, 31)]
ON_TOL = {"bfloat16": (1e-2, 2e-2), "float32": (1e-5, 1e-5)}  # output, gradients: relative L2


def _seeded_state(config: str, spec, seed: int):
    """The config's full-width model on the card (seeded weights, gain_out
    1) and a train state over its weights: non-zero Adam moments at count
    REF_STEP, one EMA tree per tracked profile (the weights plus seeded
    noise), step REF_STEP."""
    import torch

    from tinyedm_tpu_torch.training.state import TrainState

    model = _seeded(config, seed=seed)
    params = {k: p.detach() for k, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def noise(scale: float) -> dict:
        return {k: torch.randn(p.shape, generator=gen, device="cuda") * scale for k, p in params.items()}

    n_ema = len(spec.ema_lengths or (spec.ema_length,)) if spec.use_ema else 0
    ema = tuple({k: params[k] + v for k, v in noise(1e-2).items()} for _ in range(n_ema))
    state = TrainState(step=REF_STEP, params=params, constants=dict(model.named_buffers()), mu=noise(1e-3),
                       nu={k: v.square() for k, v in noise(1e-3).items()}, count=REF_STEP, ema=ema)
    return model, state


def _hand_built_reference(model, heads: int) -> dict:
    """The reference layout of ``model``'s state dict, made here rather
    than by utils/interop.py: the reference's names, and the qkv conv's
    output channels reordered (3, heads, hd) -> (heads, hd, 3) by a reshape
    of this script's own."""
    renames = {"cat_factor.conv_0.": "cat_factor.layer1.", "cat_factor.conv_1.": "cat_factor.layer2."}
    out = {}
    for key, value in model.state_dict().items():
        for old, new in renames.items():
            key = key.replace(old, new)
        key = {"u.linear.weight": "u.linear1.weight", "u.linear_out.weight": "u.linear2.weight"}.get(key, key)
        value = value.detach().float().cpu()
        if key.endswith("attention.qkv_conv.weight"):
            o = value.shape[0]
            value = value.reshape(3, heads, o // 3 // heads, *value.shape[1:]).movedim(0, 2).reshape(value.shape)
        out[key] = value.contiguous().clone()
    return out


def _fp32_forward(config: str, weights: dict):
    """The config's model in fp32 holding ``weights``: one forward at batch
    REF_FWD_BATCH on seeded inputs."""
    import torch

    from tinyedm_tpu_torch.configs import model_from_config

    p = PATHS[config]
    with torch.device("cuda"):
        model = model_from_config(config, torch.float32).eval()
    model.load_state_dict(weights)
    channels = model.denoiser.conv_in.weight.shape[1] - 1
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((REF_FWD_BATCH, channels, p["side"], p["side"]), generator=g, device="cuda")
    sigma = torch.exp(torch.randn((REF_FWD_BATCH,), generator=g, device="cuda") * 1.2 - 0.4)
    labels = torch.randint(0, p["classes"] or 10, (REF_FWD_BATCH,), generator=g, device="cuda")
    with torch.no_grad():
        return model(x * sigma[:, None, None, None], sigma, labels)


def phase_reference_checkpoints(smi: str, tmp: Path) -> None:
    """Lightning .ckpt export and import at full width (docstring, phase 32)."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, load_config
    from tinyedm_tpu_torch.configs import build_model
    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from tinyedm_tpu_torch.utils import interop
    from tinyedm_tpu_torch.utils.interop import save_weights

    for config, yaml_name in REF_CONFIGS.items():
        yaml_path = ROOT / "experiments" / "conf" / yaml_name
        spec = instantiate(load_config(yaml_path)["model"])
        model, state = _seeded_state(config, spec, seed=3)
        n_params = sum(p.numel() for p in state.params.values())
        src, ckpt, imported = tmp / f"{config}_src", tmp / f"{config}.ckpt", tmp / f"{config}_imported"
        save_checkpoint(src, state, config={"model": deinstantiate(spec)})
        index = len(state.ema) - 1  # ImageNet-512: the second profile (0.13)
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            interop.main(["export", "--ckpt_dir", str(src), "--out", str(ckpt), "--ema_index", str(index)])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            interop.main(["import", "--torch_ckpt", str(ckpt), "--config", str(yaml_path), "--out_dir",
                          str(imported), "--load_ema"])
        import_s = time.perf_counter() - t0
        ckpt_mb = ckpt.stat().st_size / 1e6
        back, _ = load_checkpoint(imported)
        cpu = {k: v.cpu() for k, v in state.params.items()}
        ema_cpu = {k: v.cpu() for k, v in state.ema[index].items()}
        same_params = set(back.params) == set(cpu) and all(torch.equal(back.params[k], v) for k, v in cpu.items())
        same_ema = len(back.ema) == 1 and all(torch.equal(back.ema[0][k], v) for k, v in ema_cpu.items())
        if not (same_params and same_ema and back.step == REF_STEP and back.count == 0):
            fail(f"{config} .ckpt round trip: params equal {same_params}, EMA profile {index} equal {same_ema}, "
                 f"step {back.step} (expected {REF_STEP}), Adam count {back.count} (expected 0)")
        print(f"[32 reference ckpt] {config} ({n_params:,} parameters, {len(state.ema)} EMA profile(s)): "
              f"export -> {ckpt.name} {ckpt_mb:.1f} MB in {export_s:.3f} s, import --load_ema in {import_s:.3f} s "
              f"({sum(p.stat().st_size for p in imported.rglob('*') if p.is_file()) / 1e6:.1f} MB written); "
              f"params, EMA profile {index} and step {REF_STEP} bit-equal after the round trip", flush=True)
        del back

        # sampling through the CLI from the imported checkpoint, against the
        # original EMA tree as a weights file
        p = PATHS[config]
        n, side = p["batch"], p["side"]
        args = ["--ckpt_path", str(imported), "--load_ema", "--num_samples", str(n), "--batch_size", str(n),
                "--image_size", str(side), "--output_dir", str(tmp / f"{config}_cli")]
        common = dict(keep_samples=True)
        if config == "imagenet512":
            args += ["--num_classes", "1000", "--num_channels", "4", "--mean", *map(str, LATENT_MEAN),
                     "--std", *map(str, LATENT_STD)]
            common.update(num_classes=1000, num_channels=4, mean=LATENT_MEAN, std=LATENT_STD)
        _clear_counts()
        with contextlib.redirect_stdout(said):
            from_ckpt = _cli_generate(args)
        counts = {k: v for k, v in fa.launch_counts.items() if v}
        expected = {("fwd", m): 63 * c for m, c in p["calls"].items()}
        if "EMA weights loaded." not in said.getvalue() or counts != expected:
            fail(f"{config} generate --ckpt_path --load_ema: launches {counts}, expected {expected}")
        ema_model = build_model(config, "cpu")
        ema_model.load_state_dict({**ema_cpu, **{k: v.cpu() for k, v in state.constants.items()}})
        save_weights(ema_model, tmp / f"{config}_ema.pt", config)
        del ema_model
        direct = generate(str(tmp / f"{config}_b"), n, side, n, weights=str(tmp / f"{config}_ema.pt"), **common)
        pngs = sorted((tmp / f"{config}_cli").glob("*.png"))
        same_png = all(x.read_bytes() == (tmp / f"{config}_b" / x.name).read_bytes() for x in pngs)
        equal = np.array_equal(from_ckpt["samples"], direct["samples"])
        if len(pngs) != n or not same_png or not equal or not np.isfinite(direct["samples"]).all():
            fail(f"{config} generate from the imported .ckpt: {len(pngs)} PNGs, equal {same_png}, samples {equal}")
        print(f"[32 reference ckpt] {config} generate --ckpt_path <imported> --load_ema (Heun-32, batch {n}): "
              f"{len(pngs)} PNGs and samples bit-equal to generate() from the original EMA tree; launches "
              f"{_fmt(counts)} ({from_ckpt['img_per_s']:.2f} img/s)", flush=True)

        # a .ckpt of the reference layout made here, imported: the same forward
        hand = _hand_built_reference(model, spec.denoiser.num_heads)
        torch.save({"state_dict": hand, "global_step": 7}, tmp / f"{config}_hand.ckpt")
        with contextlib.redirect_stdout(said):
            interop.import_torch_checkpoint(tmp / f"{config}_hand.ckpt", yaml_path, tmp / f"{config}_hand")
        hand_state, _ = load_checkpoint(tmp / f"{config}_hand")
        ours = _fp32_forward(config, {k: v.float() for k, v in model.state_dict().items()})
        theirs = _fp32_forward(config, {**hand_state.params, **hand_state.constants})
        err = rel_l2(theirs, ours)
        if not (torch.isfinite(theirs).all() and err <= 1e-4):
            fail(f"{config} hand-built reference .ckpt: forward rel L2 {err} to the original (<= 1e-4)")
        print(f"[32 reference ckpt] {config} hand-built reference layout (qkv reordered (heads, hd, 3) by this "
              f"script's reshape, the reference's names): its import's fp32 forward at batch {REF_FWD_BATCH} "
              f"within rel L2 {err:.3g} of the original (<= 1e-4), step {hand_state.step} | {smi}", flush=True)
        del model, state, hand, hand_state, ours, theirs
        for path in (src, ckpt, imported, tmp / f"{config}_hand", tmp / f"{config}_hand.ckpt"):
            shutil.rmtree(path) if path.is_dir() else path.unlink()
        torch.cuda.empty_cache()


def _knob_batches(config: str, batch: int, steps: int, channels: int):
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device

    p = PATHS[config]
    data = SyntheticDataModule(batch, image_size=p["side"], num_channels=channels, num_samples=batch * steps,
                               num_classes_=p["classes"] or 10, seed=0)
    return [to_device(x, y, "cuda") for x, y in data.train_batches(0)]


def _knob_steps(config: str, knobs: dict) -> dict:
    """The recipe's train step (bf16) with the Denoiser ``knobs``: KNOB_STEPS
    warm-up and timed steps; ms/step, peak GiB, the losses, the launches."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    p = PATHS[config]
    model, diffuser, opt_cfg, ema_cfg, batch, interval = build_training(config, "cuda", seed=0, knobs=knobs)
    warm, timed = KNOB_STEPS
    batches = _knob_batches(config, batch, warm + timed, model.denoiser.conv_in.weight.shape[1] - 1)
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    count = (lambda i: p["sched"] + i) if interval == "step" else (lambda i: p["sched"])
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _clear_counts()
    for i in range(warm):
        state, m = step(state, batches[i], gen, count(i))
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warm, warm + timed):
        state, m = step(state, batches[i], gen, count(i))
        losses.append(m["train_loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / timed
    out = dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30, batch=batch,
               losses=torch.stack(losses).float().cpu(), counts={k: v for k, v in fa.launch_counts.items() if v})
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def _knob_grads(config: str, knobs: dict, dtype) -> tuple:
    """(loss, all gradients flat) of one step's grad_fn on the recipe's first
    batch, the model in ``dtype`` with the Denoiser ``knobs``, cuDNN
    deterministic."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_grad_fn

    model, diffuser, opt_cfg, _, batch, _ = build_training(config, "cuda", dtype, seed=0, knobs=knobs)
    batches = _knob_batches(config, batch, 1, model.denoiser.conv_in.weight.shape[1] - 1)
    state = init_train_state(model, opt_cfg, None)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss, _, grads = make_grad_fn(model, diffuser, opt_cfg)(
            state, *batches[0], torch.Generator(device="cuda").manual_seed(1))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    del model, state, grads
    torch.cuda.empty_cache()
    return loss.detach().float().cpu(), flat


def phase_knobs(smi: str) -> list[dict]:
    """remat, the bf16 island and fused="on" on the card (docstring, phase
    33); returns the kernel entries of rows 1-4 at n 1024 under fused="on"."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.configs import build_model
    from tinyedm_tpu_torch.models.layers import CosineAttention
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    # remat: the recipe steps, then one step's fp32 gradients
    remat_off = {}
    for config in ("cifar10", "imagenet512"):
        runs = {form: _knob_steps(config, knobs) for form, knobs in REMAT_FORMS.items()}
        off = runs["off"]
        remat_off[config] = off
        for form, r in runs.items():
            if not torch.isfinite(r["losses"]).all():
                fail(f"{config} remat {form}: non-finite losses {r['losses'].tolist()}")
            if not torch.equal(r["losses"][0], off["losses"][0]):
                fail(f"{config} remat {form}: step 0 loss {r['losses'][0].item()} != {off['losses'][0].item()}")
            print(f"[33 knobs] {config} recipe step b={r['batch']} bf16 remat {form}: {r['ms']:.3f} ms/step "
                  f"({KNOB_STEPS[1]} timed after {KNOB_STEPS[0]}), peak {r['peak_gib']:.3f} GiB, step 0 loss "
                  f"{r['losses'][0].item():.6f} (bit-equal to remat off), losses {r['losses'][0]:.4f} .. "
                  f"{r['losses'][-1]:.4f}; launches {_fmt(r['counts'])}", flush=True)
        loss_off, g_off = _knob_grads(config, {}, torch.float32)
        _, g_off2 = _knob_grads(config, {}, torch.float32)
        spread = rel_l2(g_off2, g_off)
        gate = max(1e-6, spread)
        del g_off2
        for form in ("full", "convs"):
            loss, g = _knob_grads(config, REMAT_FORMS[form], torch.float32)
            err = rel_l2(g, g_off)
            if not (torch.equal(loss, loss_off) and err <= gate):
                fail(f"{config} remat {form} fp32: loss {loss.item()} vs {loss_off.item()}, gradients rel L2 "
                     f"{err} > {gate}")
            print(f"[33 knobs] {config} one step fp32 (cuDNN deterministic) remat {form} vs off: loss bit-equal, "
                  f"gradients rel L2 {err:.3g} (<= {gate:.3g}: 1e-6 or the spread of two remat-off runs, "
                  f"{spread:.3g}; {g.numel():,} values)", flush=True)
            del g
        del g_off
        torch.cuda.empty_cache()

    # the bf16 island: CIFAR-10 forward and step against mod_fp32=True
    p = PATHS["cifar10"]
    outs = {}
    for mod_fp32 in (True, False):
        model = build_model("cifar10", "cuda", seed=0, knobs=dict(mod_fp32=mod_fp32))
        with torch.no_grad():
            model.denoiser.gain_out.fill_(1.0)
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((p["batch"], 3, p["side"], p["side"]), generator=g, device="cuda")
        sigma = torch.exp(torch.randn((p["batch"],), generator=g, device="cuda") * 1.2 - 1.2)
        with torch.no_grad():
            outs[mod_fp32] = model(x * sigma[:, None, None, None], sigma)
        del model
    fwd_err = rel_l2(outs[False], outs[True])
    loss_t, g_t = _knob_grads("cifar10", {}, torch.bfloat16)
    loss_f, g_f = _knob_grads("cifar10", dict(mod_fp32=False), torch.bfloat16)
    step_err = rel_l2(g_f, g_t)
    island = _knob_steps("cifar10", dict(mod_fp32=False))
    if not (torch.isfinite(outs[False]).all() and torch.isfinite(island["losses"]).all()):
        fail("mod_fp32=False: non-finite forward or losses")
    print(f"[33 knobs] cifar10 mod_fp32=False (the bf16 island) vs True: forward b={p['batch']} rel L2 "
          f"{fwd_err:.3g}; one step's bf16 gradients rel L2 {step_err:.3g} (loss {loss_f.item():.6f} vs "
          f"{loss_t.item():.6f}); {island['ms']:.3f} ms/step, peak {island['peak_gib']:.3f} GiB (mod_fp32=True, "
          f"remat off above: {remat_off['cifar10']['ms']:.3f} ms/step, {remat_off['cifar10']['peak_gib']:.3f} GiB)",
          flush=True)
    del outs, g_t, g_f

    # fused="on" past MAX_FUSED_TOKENS: the layer against fused="off"
    _clear_counts()
    for b, c, side in ON_LAYERS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            with torch.device("cuda"):
                on, off = CosineAttention(c, HEADS, dtype=dtype, fused="on"), CosineAttention(c, HEADS, dtype=dtype,
                                                                                             fused="off")
            g = torch.Generator(device="cuda").manual_seed(side)
            for m in (on, off):
                m.qkv_conv.weight.data.normal_(generator=torch.Generator(device="cuda").manual_seed(1))
                m.out_conv.weight.data.normal_(generator=torch.Generator(device="cuda").manual_seed(2))
            x = torch.randn((b, c, side, side), generator=g, device="cuda").to(dtype)
            cot = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
            res = []
            for m in (on, off):
                xi = x.clone().requires_grad_(True)
                y = m(xi)
                grads = torch.autograd.grad(y, [xi, m.qkv_conv.weight, m.out_conv.weight], cot)
                res.append((y.detach(), grads))
            out_tol, grad_tol = ON_TOL[name]
            out_err = rel_l2(res[0][0], res[1][0])
            grad_errs = [rel_l2(a, r) for a, r in zip(res[0][1], res[1][1])]
            if not (out_err <= out_tol and max(grad_errs) <= grad_tol):
                fail(f"fused='on' b={b} C={c} n={side * side} {name}: output rel L2 {out_err} (<= {out_tol}), "
                     f"gradients (x, w_qkv, w_out) {grad_errs} (<= {grad_tol})")
            print(f"[33 knobs] CosineAttention(fused='on') b={b} C={c} heads={HEADS} n={side * side} {name} vs "
                  f"fused='off': output rel L2 {out_err:.3g} (<= {out_tol}), gradients x/w_qkv/w_out "
                  f"{', '.join(f'{e:.3g}' for e in grad_errs)} (<= {grad_tol})", flush=True)
    layer_counts = {k: v for k, v in fa.launch_counts.items() if v}
    expected = {(d, side * side): 2 for _, _, side in ON_LAYERS for d in ("fwd", "bwd")}
    if layer_counts != expected:
        fail(f"fused='on' layer checks launched {layer_counts}, expected {expected}")
    print(f"[33 knobs] fused='on' layer checks launched {_fmt(layer_counts)} (rows 1-4's kernels at n past "
          f"MAX_FUSED_TOKENS = {fa.MAX_FUSED_TOKENS})", flush=True)

    # rows 1-4's kernels at the n = 1024 layer shape, timed
    entries = []
    b, c, side = ON_LAYERS[0]
    n, hd = side * side, c // HEADS
    qkv = _qkv(b, n, HEADS, hd, torch.bfloat16, seed=n)
    gy = _cotangent(b, n, HEADS, hd, torch.bfloat16, seed=n)
    o = fa.cosine_attention_qkv_cuda(qkv, HEADS)
    torch.cuda.synchronize()
    err = _check(o, fa.cosine_attention_qkv_plain(qkv, HEADS), "bfloat16", f"fused=on fwd n={n}")
    dq = fa.cosine_attention_qkv_bwd_cuda(qkv, gy, o, HEADS)
    torch.cuda.synchronize()
    berr, brel = _check_bwd(dq, fa.cosine_attention_qkv_bwd_plain(qkv, gy, o, HEADS), "bfloat16",
                            f"fused=on bwd n={n}")
    xq = pixel_norm(qkv.reshape(b, n, 3, HEADS, hd), dim=-1)
    q, k, v = (t.transpose(1, 2).contiguous() for t in xq.unbind(2))
    gh = gy.reshape(b, n, HEADS, hd).transpose(1, 2).contiguous()
    fwd = dict(ms=time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, HEADS)),
               plain_ms=time_ms(lambda: fa.cosine_attention_qkv_plain(qkv, HEADS), iters=5),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    fwd["bound_ms"], fwd["bound_by"] = _bound(4 * b * n * c * 2, 4 * b * HEADS * n * n * hd, "bfloat16")
    bwd = dict(ms=time_ms(lambda: fa.cosine_attention_qkv_bwd_cuda(qkv, gy, o, HEADS), iters=10),
               plain_ms=time_ms(lambda: fa.cosine_attention_qkv_bwd_plain(qkv, gy, o, HEADS), iters=3),
               library_ms=_sdpa_bwd_ms(q, k, v, gh)[0])
    bwd["bound_ms"], bwd["bound_by"] = _bound(8 * b * n * c * 2, 10 * b * HEADS * n * n * hd, "bfloat16")
    for direction, r, e, src, replaces in (("fwd", fwd, err, "cosine_attention_fwd.cu", f"{FUSED_FWD}:102"),
                                           ("bwd", bwd, berr, "cosine_attention_bwd.cu", f"{FUSED_FWD}:144")):
        print(f"[33 knobs] cosine_attention_{direction} fused='on' b={b} n={n} C={c} heads={HEADS} bfloat16: "
              f"max_abs {e:.3g} | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {smi}", flush=True)
        entries.append(_entry(
            f"cosine_attention_{direction}[fused=on n={n} hd={hd}]", src, replaces, e, r["ms"], r["plain_ms"],
            r["bound_ms"], r["bound_by"], r["library_ms"], launches=layer_counts[direction, n],
            path="fused='on' layer check (CosineAttention at n 1024, bf16 and fp32)"))
    return entries


# ---------------------------------------------------------------------------
# phases 34-35: data parallelism and ZeRO-1 (tinyedm_tpu_torch/parallel), the
# CLIs over ranks
# ---------------------------------------------------------------------------
DP_RANKS, DP_GLOBAL, DP_STEPS = 2, 256, 3  # (b), (c): 2 x 128 of each global batch of 256, 3 steps
# (b): the param and EMA moves and the Adam moments after 3 steps at 2 x 128
# against 1 x 256, relative L2. Read on an H100 at 1.35e-3 (param moves),
# 1.31e-3 (EMA moves), 7.9e-4 (mu) and 7.0e-4 (nu): bf16 gradients of two
# half batches, summed in another order. A sum left undivided by the world
# size reads 1.0 in mu and 3.0 in nu; a rank's own gradient in place of the
# mean reads its half batch's noise.
DP_TOL = 5e-3
DP_TIMEOUT = 600  # seconds for the spawned ranks, the build's load included
DP_GEN = 64  # phase 35's generate: CIFAR-10 Heun-32, 64 samples at batch 64 (2 x 32)
DP_CLI_TRAIN, DP_CLI_TEST = 256, 256  # phase 35's short epoch: 5 steps of 256, one val batch
DP_LOOP_TRAIN = 512  # 34 (a): 5 x 512 synthetic images, 2 epochs of 10 steps of 256


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _content_diffuser():
    """The injected draws of phase 34 (b): each image's sigma and noise a
    function of the image alone (two of its pixels, its mirror image), so
    a row draws the same on any rank and in one process
    (tests/_torch_dist_worker.py's ContentDiffuser)."""
    from tinyedm_tpu_torch.diffusion.diffuser import Diffuser

    class ContentDiffuser(Diffuser):
        def __call__(self, clean_image, generator):
            x = clean_image.float()
            return self.apply(clean_image, 1.5 * (x[:, 0, 0, 0] + x[:, -1, -1, -1]), 1.5 * x.flip(1, 2, 3))

    return ContentDiffuser()


def _dp_steps(device, zero1: bool, grouped: bool) -> dict:
    """DP_STEPS steps of the CIFAR-10 recipe at full width, dropout 0, draws
    injected, from the seed-0 state, on this rank's share of each global
    batch of DP_GLOBAL (the whole batch without a group); the whole state
    after them on the host, ms/step of the steps after the first, the
    collectives and the rows 1-4 launches of each step, the bytes of the
    moments and EMA trees this rank keeps."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.parallel.audit import collective_inventory
    from tinyedm_tpu_torch.parallel.mesh import ParallelPlan, shard_batch
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    model, _, opt_cfg, ema_cfg, _, _ = build_training("cifar10", device, seed=0)
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    state = init_train_state(model, opt_cfg, ema_cfg)
    start = {k: v.detach().cpu() for k, v in state.params.items()}
    plan = ParallelPlan(dict(model.named_parameters()), zero1=zero1) if grouped else None
    if zero1:
        plan.place(state)
    step = make_train_step(model, _content_diffuser(), opt_cfg, ema_cfg, plan=plan)
    data = SyntheticDataModule(DP_GLOBAL, image_size=32, num_samples=DP_GLOBAL * DP_STEPS, seed=0)
    batches = [to_device(*shard_batch(b), device) for b in data.train_batches(0)]  # this rank's rows
    inventories, launches, times = [], [], []
    for batch in batches:
        fa.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_inventory() as inv:
            state, metrics = step(state, batch, torch.Generator(device=device).manual_seed(0),
                                  PATHS["cifar10"]["sched"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        inventories.append(inv)
        launches.append(_kernel_calls())
    if not torch.isfinite(metrics["train_loss"]):
        fail(f"phase 34: non-finite loss {metrics['train_loss']}")

    def host(tree, gather=zero1):
        return {k: v.detach().cpu() for k, v in (plan.gather(tree) if gather else tree).items()}

    kept = sum(v.numel() * 4 for v in (*state.mu.values(), *state.nu.values()))
    kept_ema = sum(v.numel() * 4 for tree in state.ema for v in tree.values())
    out = dict(start=start, params=host(state.params, False), mu=host(state.mu), nu=host(state.nu),
               ema=[host(t) for t in state.ema],
               ms=1e3 * statistics.mean(times[1:]), inventories=inventories, launches=launches,
               moment_bytes=kept, ema_bytes=kept_ema, rows=len(batches[0][0]))
    del state, model, step, batches
    torch.cuda.empty_cache()
    return out


def _dp_rank(rank: int, size: int, store: str, out: str, backend: str, gen_dir: str | None) -> None:
    """One spawned rank of phase 34 (b) or (c): the data-parallel steps, then
    the ZeRO-1 steps, checked bit for bit against them here; with
    ``gen_dir``, phase 35's generate() of its rows. Writes its numbers (and
    rank 0 its whole state) to ``out``."""
    import os
    from datetime import timedelta

    import torch

    sys.path.insert(0, str(ROOT))
    # (b): both ranks on the one card; (c): one card each
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank if backend == "nccl" else 0))
    from tinyedm_tpu_torch.parallel import mesh
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    mesh.init_distributed(backend=backend, init_method=f"file://{store}", timeout=timedelta(seconds=DP_TIMEOUT))
    device = resolve_device(None)
    # ZeRO-1's all-gather of CUDA tensors, checked before the steps need it
    probe = torch.arange(4, dtype=torch.float32, device=device) + 4 * rank
    whole = torch.empty(4 * size, device=device)
    mesh.all_gather_into(whole, probe)
    if not torch.equal(whole.cpu(), torch.arange(4 * size, dtype=torch.float32)):
        fail(f"{backend} all_gather gave {whole.tolist()}")
    dp = _dp_steps(device, zero1=False, grouped=True)
    z1 = _dp_steps(device, zero1=True, grouped=True)
    trees = [(dp[k], z1[k]) for k in ("params", "mu", "nu")] + list(zip(dp["ema"], z1["ema"]))
    equal = all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a) for a, b in trees)
    result = dict(backend=backend, equal=equal, device=str(device), rows=dp["rows"])
    for name, r in (("dp", dp), ("zero1", z1)):
        result[name] = {k: r[k] for k in ("ms", "inventories", "launches", "moment_bytes", "ema_bytes")}
    if rank == 0:
        result["state"] = {k: dp[k] for k in ("start", "params", "mu", "nu", "ema")}
    if gen_dir is not None:
        from tinyedm_tpu_torch.generate import generate

        t0 = time.perf_counter()
        generate(gen_dir, DP_GEN, 32, DP_GEN, config="cifar10", num_steps=32, seed=0)
        result["gen_s"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    torch.save(result, out)


def _spawn_ranks(backend: str, tmp: Path, gen_dir: Path | None = None) -> list[dict]:
    """DP_RANKS spawned ranks of ``_dp_rank`` in one ``backend`` group; their
    results, or a failure naming the rank that died."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    store = tmp / f"store-{backend}"
    outs = [tmp / f"rank-{backend}-{r}.pt" for r in range(DP_RANKS)]
    procs = [ctx.Process(target=_dp_rank, args=(r, DP_RANKS, str(store), str(outs[r]), backend,
                                                 None if gen_dir is None else str(gen_dir)))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * DP_RANKS or not all(o.exists() for o in outs):
        fail(f"phase 34: {backend} ranks ended with exit codes {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _per_step_inventory(inventories: list) -> str:
    from tinyedm_tpu_torch.parallel.audit import inventory_summary

    s = inventory_summary(inventories[-1])
    return ", ".join(f"{v['count']} {k} of {v['bytes'] / 1e6:.2f} MB" for k, v in s.items()) or "none"


def _print_inventory(tag: str, what: str, inv: list, param_bytes: int, rows: bool = True) -> None:
    """One program's collectives as the collective-audit CLI reports them:
    the summary, the payload, the ring estimate of the bytes a rank puts on
    the wire beside the params' bytes, and ``format_inventory``'s rows."""
    from tinyedm_tpu_torch.parallel.audit import format_inventory, inventory_summary, wire_bytes

    print(f"[{tag}] {what}: {inventory_summary(inv)}; payload total {sum(c.bytes for c in inv) / 1e6:.2f} MB, "
          f"ring-estimate wire bytes a rank {sum(wire_bytes(c) for c in inv) / 1e6:.2f} MB (params "
          f"{param_bytes / 1e6:.2f} MB fp32)" + ("" if rows else f"; {len(inv)} rows not shown"), flush=True)
    if rows:
        for row in format_inventory(inv).splitlines():
            print(f"[{tag}]   {row}", flush=True)


def _flat(tree: dict, order: dict | None = None):
    """One fp64 vector of a host tree's tensors, in ``order``'s keys (its own
    by default)."""
    import torch

    return torch.cat([tree[k].reshape(-1).double() for k in (order or tree)])


def _check_ranks(tag: str, ranks: list[dict], ref: dict, smi: str) -> None:
    """Phase 34 (b)/(c)'s gates and lines for one group's results."""
    import torch

    r0 = ranks[0]
    backend = r0["backend"]
    if not all(r["equal"] for r in ranks):
        fail(f"{tag}: ZeRO-1 is not bit-equal to data parallel on every rank")
    # what the steps changed, against one process: the param and EMA moves
    # from the shared start, and the Adam moments (a sum left undivided by
    # the world size doubles mu and quadruples nu; Adam's update hides it)
    ours, theirs = r0["state"], ref
    if not torch.equal(_flat(ours["start"]), _flat(theirs["start"], ours["start"])):
        fail(f"{tag}: the ranks did not start from the one process's state")
    pairs = [("d_params", ours["params"], theirs["params"], True), ("mu", ours["mu"], theirs["mu"], False),
             ("nu", ours["nu"], theirs["nu"], False)] + [
        (f"d_ema{i}", a, b, True) for i, (a, b) in enumerate(zip(ours["ema"], theirs["ema"]))]
    errs = {}
    for name, a, b, moved in pairs:
        base = _flat(ours["start"], a) if moved else 0.0
        errs[name] = rel_l2(_flat(a) - base, _flat(b, a) - base)
    if not max(errs.values()) <= DP_TOL:
        fail(f"{tag}: {DP_RANKS} x {r0['rows']} against 1 x {DP_GLOBAL}: {errs} > {DP_TOL}")
    calls = PATHS["cifar10"]["calls"]
    want = {(d, n): c for n, c in calls.items() for d in ("fwd", "bwd")}
    for r in ranks:
        for name in ("dp", "zero1"):
            if any(step != want for step in r[name]["launches"]):
                fail(f"{tag}: rows 1-4 launches per rank step {r[name]['launches']}, expected {want}")
    note = "host-staged gloo, NOT NCCL's speed" if backend == "gloo" else "NCCL"
    dp, z1 = r0["dp"], r0["zero1"]
    z1_moments = ", ".join(f"{r['zero1']['moment_bytes'] / 1e6:.2f}" for r in ranks)
    z1_ema = ", ".join(f"{r['zero1']['ema_bytes'] / 1e6:.2f}" for r in ranks)
    print(f"[{tag}] {backend} on {', '.join(sorted({r['device'] for r in ranks}))}, {DP_RANKS} ranks x "
          f"{r0['rows']} of each global batch of {DP_GLOBAL}, {DP_STEPS} steps, bf16, dropout 0, draws injected: "
          f"the param and EMA moves and the moments against one process at {DP_GLOBAL} from the same state, "
          f"relative L2 {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (<= {DP_TOL}); ZeRO-1 bit-equal to "
          f"data parallel (params, mu, nu, EMA) on every rank", flush=True)
    print(f"[{tag}] per step and rank: data parallel {dp['ms']:.3f} ms, ZeRO-1 {z1['ms']:.3f} ms ({note}); "
          f"collectives dp {_per_step_inventory(dp['inventories'])}; zero1 "
          f"{_per_step_inventory(z1['inventories'])}; rows 1-4 launches {_fmt(want)} per rank step, as phase 9's "
          f"per step; moment bytes per rank dp {dp['moment_bytes'] / 1e6:.2f} MB, zero1 {z1_moments} MB; EMA bytes "
          f"dp {dp['ema_bytes'] / 1e6:.2f} MB, zero1 {z1_ema} MB | {smi}", flush=True)
    param_bytes = 4 * sum(v.numel() for v in ours["start"].values())
    for name, r in (("data parallel", dp), ("ZeRO-1", z1)):
        _print_inventory(tag, f"{name}, one rank step", r["inventories"][-1], param_bytes)


def phase_data_parallel(smi: str, loop_ms: float | None, bare: dict, lap=None) -> None:
    """Phase 34 (docstring): (a) a one-rank NCCL group through the CIFAR-10
    run loop, (b) two ranks sharing the card over gloo, (c) two cards over
    NCCL where there are two; then phase 35, whose two-rank generate runs in
    (b)'s ranks. ``loop_ms``: phase 24's loop (None where it did not run),
    ``bare``: phase 9's step, printed beside (a)'s."""
    import os

    import torch

    from tinyedm_tpu_torch.parallel.audit import collective_inventory, inventory_summary
    from tinyedm_tpu_torch.parallel.mesh import distributed

    p = PATHS["cifar10"]
    calls = p["calls"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) train --multihost in this process, over a one-rank NCCL group:
        # 2 epochs of 10 steps, the second epoch's rate read, as phase 24's
        _write_cifar10(tmp / "cifar10", n_train=DP_LOOP_TRAIN)
        run = tmp / "run"
        args = ["--config-name=cifar10", f"--config-path={ROOT / 'experiments' / 'conf'}", "--multihost",
                f"datamodule.data_dir={tmp / 'cifar10'}", f"trainer.out_dir={run}",
                f"trainer.max_epochs={LOOP_EPOCHS}", "trainer.check_val_every_n_epoch=1",
                "callbacks.checkpoint_callback.every_n_epochs=1", "callbacks.generate_callback.every_n_epochs=1"]
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        os.environ.update(env)
        _clear_counts()
        try:
            with collective_inventory() as inv:
                trainer, out, fit_s = _run_train(args, "34 data parallel")
        finally:
            for k in env:
                os.environ.pop(k)
        counts = _kernel_calls()
        if distributed():
            fail("34 (a): train --multihost left its process group behind")
        steps = trainer.global_step
        val_batches = -(-LOOP_TEST // trainer.datamodule.batch_size)
        forwards = steps + LOOP_EPOCHS * (val_batches + LOOP_PREVIEW_FORWARDS)
        expected = {(d, n): c * (forwards if d == "fwd" else steps) for n, c in calls.items() for d in ("fwd", "bwd")}
        grads = [c for c in inv if c.kind == "all_reduce" and c.bytes >= trainer.plan.param_bytes]
        scalars = [c for c in inv if c.kind == "all_reduce" and c.bytes < trainer.plan.param_bytes]
        summary = inventory_summary(inv)
        _, _, sample_ms, sps = _loop_numbers(run, trainer.datamodule.batch_size)
        ok = (steps == LOOP_EPOCHS * 5 * DP_LOOP_TRAIN // trainer.datamodule.batch_size and counts == expected
              and len(grads) == steps and all(c.group_size == 1 for c in inv) and len(scalars) == LOOP_EPOCHS
              and "all_gather" not in summary)
        if not ok or "device: cuda:0" not in out:
            fail(f"34 (a): {steps} steps, launches {counts} (expected {expected}), collectives {summary}")
        print(f"[34 data parallel] (a) train --multihost over a one-rank NCCL group in this process, cifar10.yaml, "
              f"{LOOP_EPOCHS} epochs x {steps // LOOP_EPOCHS} steps of {trainer.datamodule.batch_size}, validation "
              f"and preview each epoch, {fit_s:.3f} s: epoch {LOOP_EPOCHS} {sample_ms:.3f} ms/step, {sps:.2f} "
              f"samples/s (phase 24's loop in this run {'not run' if loop_ms is None else f'{loop_ms:.3f}'}, "
              f"phase 9's bare step {bare['ms']:.3f} ms/step); per step one all_reduce of "
              f"{grads[0].bytes / 1e6:.2f} MB (the params {trainer.plan.param_bytes / 1e6:.2f} MB, the alignment "
              f"gaps and {(grads[0].bytes - 4 * trainer.plan.padded) // 4} scalars), no all_gather; each "
              f"validation one all_reduce of {scalars[0].bytes} B; in all {summary}; launches {_fmt(counts)} | "
              f"{smi}", flush=True)
        _print_inventory("34 data parallel", "(a) one loop step", grads[:1], trainer.plan.param_bytes)
        del trainer
        torch.cuda.empty_cache()

        # (b) two ranks on this card over gloo, against one process at the global batch
        ref = _dp_steps("cuda", zero1=False, grouped=False)
        ref = {k: ref[k] for k in ("start", "params", "mu", "nu", "ema", "ms")}
        torch.cuda.empty_cache()
        print(f"[34 data parallel] (b) one process at {DP_GLOBAL}: {ref['ms']:.3f} ms/step", flush=True)
        t0 = time.perf_counter()
        ranks = _spawn_ranks("gloo", tmp, gen_dir=tmp / "gen-2")
        spawn_s = time.perf_counter() - t0
        _check_ranks("34 data parallel (b)", ranks, ref, smi)
        print(f"[34 data parallel] (b) the two ranks ran {spawn_s:.1f} s, start-up, steps and phase 35's generate "
              "included", flush=True)
        # (c) two cards over NCCL
        if torch.cuda.device_count() >= 2:
            _check_ranks("34 data parallel (c)", _spawn_ranks("nccl", tmp), ref, smi)
        else:
            print(f"[34 data parallel] (c) NCCL over two cards did not run: this machine has "
                  f"{torch.cuda.device_count()} card", flush=True)

        if lap is not None:
            lap("34")
        # 35: the CLIs over ranks
        phase_dp_clis(smi, tmp, ranks)


def phase_dp_clis(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 35 (docstring): train --multihost under torch.distributed.run,
    and the two-rank generate of phase 34 (b)'s ranks against one process."""
    import numpy as np

    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.training.callbacks import read_png

    data, run = tmp / "cifar10-short", tmp / "run-cli"
    _write_cifar10(data, n_train=DP_CLI_TRAIN, n_test=DP_CLI_TEST)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "tinyedm_tpu_torch.train", "--multihost",
           "--config-name=cifar10", f"--config-path={ROOT / 'experiments' / 'conf'}", f"datamodule.data_dir={data}",
           f"trainer.out_dir={run}", "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
           "callbacks.checkpoint_callback.every_n_epochs=1", "callbacks.generate_callback=null"]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=DP_TIMEOUT)
    cli_s = time.perf_counter() - t0
    steps = 5 * DP_CLI_TRAIN // 256
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()] if done.returncode == 0 \
        else []
    ckpts = sorted(x.name for x in (run / "checkpoints").iterdir()) if rows else []
    finite = all(math.isfinite(v) for r in rows for k, v in r.items())
    if done.returncode != 0 or "device: cuda:0" not in done.stdout or not finite or ckpts != [str(steps)] or \
            [r["step"] for r in rows if "samples_per_sec" in r] != [steps]:
        fail(f"35: torch.distributed.run ... train --multihost: rc {done.returncode}, rows {rows}, checkpoints "
             f"{ckpts}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    val = next(r["val_loss"] for r in rows if "val_loss" in r)
    print(f"[35 clis] python -m torch.distributed.run --nproc_per_node 1 -m tinyedm_tpu_torch.train --multihost "
          f"--config-name=cifar10 (NCCL, one rank): 1 epoch of {steps} steps of 256 and validation of "
          f"{DP_CLI_TEST} in {cli_s:.1f} s (process start-up included), val_loss {val:.4f}, checkpoint {ckpts}",
          flush=True)

    one = generate(str(tmp / "gen-1"), DP_GEN, 32, DP_GEN, config="cifar10", num_steps=32, seed=0)
    names = sorted(x.name for x in (tmp / "gen-1").glob("*.png"))
    if names != sorted(x.name for x in (tmp / "gen-2").glob("*.png")) or len(names) != DP_GEN:
        fail(f"35: generate on two ranks wrote {sorted(x.name for x in (tmp / 'gen-2').glob('*.png'))}")
    diff = [np.abs(read_png(tmp / "gen-1" / n).astype(int) - read_png(tmp / "gen-2" / n).astype(int))
            for n in names]
    worst, differing = max(int(d.max()) for d in diff), sum(int((d > 0).sum()) for d in diff)
    if worst > 1:
        fail(f"35: generate on two ranks differs from one process by {worst} levels")
    print(f"[35 clis] generate() on two ranks sharing the card (gloo; phase 34 (b)'s ranks, 32 rows each), "
          f"cifar10 Heun-32, {DP_GEN} samples at batch {DP_GEN}: the {DP_GEN} PNGs of one process within "
          f"{worst} level ({differing} of {DP_GEN * 32 * 32 * 3} values differ: cuDNN may pick another algorithm "
          f"at batch 32); one process {one['img_per_s']:.2f} img/s, the two ranks "
          f"{max(r['gen_s'] for r in ranks):.2f} s | {smi}", flush=True)


# ---------------------------------------------------------------------------
# phase 36: tensor parallelism (tinyedm_tpu_torch/parallel/tensor.py), ranks
# sharing the one card over gloo
# ---------------------------------------------------------------------------
TP_SIZE = 2  # the model group
# (a): CIFAR-10 on a 1 x 2 grid, 3 steps with the recipe's dropout at a
# global batch of 32 (cut from 256: gloo stages every activation gather
# through the host), against one process at 32; (b): a 2 x 2 grid with
# ZeRO-1, one step of 2 x 16 against one process at 32, draws injected.
# Both start from seeded weights with gain_out = 1 (at its init value 0
# step 0 trains gain_out alone) and run twice: in the recipe's bf16 and in
# fp32. fp32 is held to DP_TOL on the param and EMA moves, mu and nu and to
# TP_LOSS_TOL on every step's loss (read on an H100 in (a): moves 1.9e-5,
# mu 5.5e-7, nu 7.4e-7, losses 3.0e-7; (b)'s mu after one step, (1 - b1) g,
# 6.7e-7). bf16 cannot be: a sharded conv's input gradient is two bf16
# partial sums added, not one rounding of the whole sum ((b)'s one-step mu
# 1.5e-3 off one process, inside bf16's own 8.4e-3 off fp32), Adam's first
# steps, g / |g|, flip the sign of near-zero elements whose gradient moved
# (the moves read 2 sqrt(flipped share)), and the later losses follow the
# weights: in (a) moves 4.3e-2, mu 2.1e-3, nu 3.8e-3, the third loss 1.9e-3
# off one process. So bf16 holds its first loss (the forward alone) to
# TP_LOSS_TOL and the rest to bf16's own distance: one process's bf16
# against its fp32 from the same state (in (a) moves 0.12, mu and nu 5.2e-3,
# loss 1.5e-2). Readings of the whole script, NVIDIA H100 80GB HBM3, 700 W.
TP_GLOBAL, TP_STEPS = 32, 3
TP_LOSS_TOL = 1e-3  # relative
TP_DTYPES = ("bfloat16", "float32")
# (c): generate --model_parallel 2 on ImageNet-512 at full width, Heun with
# num_steps 4 (7 forwards), batch 8, against one process: float samples
# within rtol = atol = 2e-2 (tests/test_tensor_parallel.py's tolerance)
TP_GEN, TP_GEN_STEPS, TP_GEN_TOL = 8, 4, 2e-2
TP_TIMEOUT = 900  # seconds for a spawn, start-up included


def _tp_steps(device, grid, zero1: bool, steps: int, dropout: bool, dtype_name: str) -> dict:
    """``steps`` steps of the CIFAR-10 recipe at full width, computing in
    ``dtype_name``, from the seed-0 state with gain_out = 1 at the global
    batch TP_GLOBAL, this rank's rows of it; the recipe's draws and dropout
    (``dropout``), else dropout 0 and draws injected. ``grid`` None: one
    process. The start and the whole state after the steps on the host, the
    losses, ms per step after the first, each step's collectives and rows
    1-4 launches, the bytes this rank keeps."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.parallel.audit import collective_inventory
    from tinyedm_tpu_torch.parallel.mesh import ParallelPlan, shard_batch
    from tinyedm_tpu_torch.parallel.tensor import gather_tree, shard_model
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step
    from tinyedm_tpu_torch.utils.cuda import step_generator

    model, diffuser, opt_cfg, ema_cfg, _, _ = build_training("cifar10", device, dtype=getattr(torch, dtype_name),
                                                             seed=0)
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    if not dropout:
        diffuser = _content_diffuser()
        for m in model.modules():
            if hasattr(m, "dropout_rate"):
                m.dropout_rate = 0.0
    shards = shard_model(model, grid) if grid is not None else {}
    state = init_train_state(model, opt_cfg, ema_cfg)
    plan = ParallelPlan(dict(model.named_parameters()), zero1=zero1, sharded=shards) if grid is not None else None
    if zero1:
        plan.place(state)

    def host(tree, ranged=True):
        tree = plan.gather(tree) if zero1 and ranged else tree
        tree = gather_tree(tree, shards, grid) if shards else tree
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    start = host(state.params, False)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg, plan=plan)
    data = SyntheticDataModule(TP_GLOBAL, image_size=32, num_samples=TP_GLOBAL * steps, seed=0)
    d, n_data = (grid.data_rank, grid.data_size) if grid is not None else (0, 1)
    batches = [to_device(*(shard_batch(b) if grid is not None else b), device) for b in data.train_batches(0)]
    inventories, launches, times, losses = [], [], [], []
    for batch in batches:
        fa.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_inventory() as inv:
            state, metrics = step(state, batch, step_generator(0, state.step, device, d, n_data),
                                  PATHS["cifar10"]["sched"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        inventories.append(inv)
        launches.append(_kernel_calls())
        losses.append(float(metrics["train_loss"]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 36: non-finite losses {losses}")

    def nbytes(trees):
        return sum(v.numel() * 4 for tree in trees for v in tree.values())

    out = dict(start=start, params=host(state.params, False), mu=host(state.mu), nu=host(state.nu),
               ema=[host(t) for t in state.ema], losses=losses,
               ms=1e3 * statistics.mean(times[1:]) if len(times) > 1 else 1e3 * times[0],
               inventories=inventories, launches=launches, rows=len(batches[0][0]),
               param_bytes=nbytes([state.params]), moment_bytes=nbytes([state.mu, state.nu]),
               ema_bytes=nbytes(state.ema))
    del state, model, step, batches
    torch.cuda.empty_cache()
    return out


def _tp_generate(out_dir: str, model_parallel: int) -> dict:
    """ImageNet-512 through ``tinyedm_tpu_torch.generate.main`` (the CLI's
    code path), with ``--model_parallel``: the float samples it kept, the
    rows this rank's PNG writer wrote, the rows 1-4 launches and the
    collectives."""
    from tinyedm_tpu_torch import generate as gen
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.parallel.audit import collective_inventory

    kept, written = [], []
    real_generate, real_write = gen.generate, gen.PreditionWriter.write_batch
    gen.generate = lambda *a, **k: kept.append(real_generate(*a, keep_samples=True, **k))
    gen.PreditionWriter.write_batch = lambda self, images, idx: written.extend(idx) or real_write(self, images, idx)
    argv = ["--config", "imagenet512", "--num_classes", "1000", "--image_size", "64", "--mean",
            *map(str, LATENT_MEAN), "--std", *map(str, LATENT_STD), "--output_dir", out_dir, "--num_samples",
            str(TP_GEN), "--batch_size", str(TP_GEN), "--num_steps", str(TP_GEN_STEPS), "--model_parallel",
            str(model_parallel)]
    fa.launch_counts.clear()
    try:
        with collective_inventory() as inv:
            gen.main(argv)
    finally:
        gen.generate, gen.PreditionWriter.write_batch = real_generate, real_write
    return dict(samples=kept[0]["samples"], seconds=kept[0]["seconds"], written=sorted(written),
                launches=_kernel_calls(), inventory=inv)


def _tp_rank(rank: int, size: int, store: str, out: str, backend: str, task: str, tmp: str) -> None:
    """One spawned rank of phase 36: (a) the 1 x 2 grid's steps, then in
    the same group (c) generate --model_parallel 2 and phase 40's audit
    (``_audit_in_rank``), so that one start-up serves the three; or (b) the
    2 x 2 grid's ZeRO-1 step. Writes its numbers to ``out``."""
    import os
    from datetime import timedelta

    import torch

    sys.path.insert(0, str(ROOT))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank if backend == "nccl" else 0))
    from tinyedm_tpu_torch.parallel import mesh
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    mesh.init_distributed(backend=backend, init_method=f"file://{store}", timeout=timedelta(seconds=TP_TIMEOUT))
    device = resolve_device(None)
    grid = mesh.make_grid(TP_SIZE)
    result = {dt: _tp_steps(device, grid, zero1=task == "b", steps=TP_STEPS if task == "a" else 1,
                            dropout=task == "a", dtype_name=dt) for dt in TP_DTYPES}
    if task == "a":
        result["c"] = _tp_generate(str(Path(tmp) / f"gen-tp-{backend}"), TP_SIZE)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["audit"] = _audit_in_rank()
        result["audit"]["seconds"] = time.perf_counter() - t0
    result.update(device=str(device), backend=backend)
    torch.distributed.destroy_process_group()
    torch.save(result, out)


def _spawn_tp(task: str, size: int, backend: str, tmp: Path) -> list[dict]:
    """``size`` spawned ranks of ``_tp_rank``; their results, or a failure
    naming the exit codes."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    store = tmp / f"store-tp-{task}-{backend}"
    outs = [tmp / f"tp-{task}-{backend}-{r}.pt" for r in range(size)]
    procs = [ctx.Process(target=_tp_rank, args=(r, size, str(store), str(outs[r]), backend, task, str(tmp)))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * size or not all(o.exists() for o in outs):
        fail(f"phase 36 ({task}): {backend} ranks ended with exit codes {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _tp_errs(ours: dict, ref: dict) -> dict:
    """Relative L2 of the param and EMA moves (each from its own start), of
    mu and nu, against ``ref``."""
    pairs = [("d_params", ours["params"], ref["params"], True), ("mu", ours["mu"], ref["mu"], False),
             ("nu", ours["nu"], ref["nu"], False)] + [
        (f"d_ema{i}", a, b, True) for i, (a, b) in enumerate(zip(ours["ema"], ref["ema"]))]
    errs = {}
    for name, a, b, moved in pairs:
        base_a, base_b = (_flat(ours["start"], a), _flat(ref["start"], a)) if moved else (0.0, 0.0)
        errs[name] = rel_l2(_flat(a) - base_a, _flat(b, a) - base_b)
    errs["loss0"] = abs(ours["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    errs["loss"] = max(abs(x - y) / abs(y) for x, y in zip(ours["losses"], ref["losses"]))
    return errs


def _tp_gates(tag: str, ranks: list[dict], ref: dict, smi: str) -> None:
    """(a)/(b)/(d)'s gates and lines: against one process from the same
    state, fp32 within DP_TOL and its losses within TP_LOSS_TOL, bf16's
    first loss within TP_LOSS_TOL and the rest within bf16's own distance
    from fp32 (the comment at TP_GLOBAL); every rank's whole state the
    same; the bytes, collectives and launches per rank."""
    import torch

    from tinyedm_tpu_torch.parallel.audit import inventory_summary

    for dt in TP_DTYPES:
        # the forced weight norm of init, per output row, sums a shard's rows
        # in another order than the whole tensor's: within fp32 rounding
        off = rel_l2(_flat(ranks[0][dt]["start"]), _flat(ref[dt]["start"], ranks[0][dt]["start"]))
        if not off <= 1e-6:
            fail(f"{tag} {dt}: the ranks' start is {off} off the one process's")
        for r in ranks[1:]:
            if not all(torch.equal(_flat(ranks[0][dt][k]), _flat(r[dt][k], ranks[0][dt][k]))
                       for k in ("params", "mu", "nu")):
                fail(f"{tag} {dt}: the ranks' gathered states differ")
    fp32 = _tp_errs(ranks[0]["float32"], ref["float32"])
    bf16 = _tp_errs(ranks[0]["bfloat16"], ref["bfloat16"])
    noise = _tp_errs(ref["bfloat16"], ref["float32"])
    bad = [k for k, v in fp32.items() if not v <= (TP_LOSS_TOL if k.startswith("loss") else DP_TOL)]
    bad += [f"bf16 {k}" for k, v in bf16.items() if not v <= (TP_LOSS_TOL if k == "loss0" else noise[k])]
    if bad:
        fail(f"{tag}: against one process: fp32 {fp32} (<= {DP_TOL}), bf16 {bf16} (<= one process's bf16 "
             f"against fp32, {noise}); failed {bad}")
    want = {(d, n): c for n, c in PATHS["cifar10"]["calls"].items() for d in ("fwd", "bwd")}
    for r in ranks:
        if any(step != want for dt in TP_DTYPES for step in r[dt]["launches"]):
            fail(f"{tag}: rows 1-4 launches per rank step {[r[dt]['launches'] for dt in TP_DTYPES]}, expected "
                 f"{want} (at {HEADS // TP_SIZE} heads)")
    r0, one = ranks[0]["bfloat16"], ref["bfloat16"]
    inv = r0["inventories"][-1]
    summary = inventory_summary(inv)
    groups = sorted({(c.kind, c.group, c.group_size) for c in inv})
    biggest = max(c.bytes for c in inv)
    # every activation gather of the forward all-reduces its gradient in the
    # backward (over the model group), beside the replicated params' sum
    gathers = sum(c.kind == "all_gather" and c.group == "model" for c in inv)
    psums = sum(c.kind == "all_reduce" and c.group == "model" for c in inv)
    if biggest >= one["param_bytes"] or not 0 < gathers < psums:
        fail(f"{tag}: collectives {groups}, {gathers} model-group gathers and {psums} model-group all-reduces, "
             f"the largest {biggest} B against the params' {one['param_bytes']} B")
    note = "host-staged gloo on one card, NOT NCCL's speed" if ranks[0]["backend"] == "gloo" else "NCCL"
    per_rank = "; ".join(f"rank {i}: params {r['bfloat16']['param_bytes'] / 1e6:.2f} MB, moments "
                         f"{r['bfloat16']['moment_bytes'] / 1e6:.2f} MB, EMA {r['bfloat16']['ema_bytes'] / 1e6:.2f} MB"
                         for i, r in enumerate(ranks))

    def fmt(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    print(f"[{tag}] {ranks[0]['backend']} on {', '.join(sorted({r['device'] for r in ranks}))}, {len(ranks)} ranks, "
          f"{r0['rows']} rows a rank of each global batch of {TP_GLOBAL}, {len(r0['losses'])} steps from seeded "
          f"weights with gain_out 1, against one process at {TP_GLOBAL} from the same state, relative L2: fp32 "
          f"{fmt(fp32)} (<= {DP_TOL}; losses <= {TP_LOSS_TOL}); bf16 (the recipe) {fmt(bf16)} (loss0 <= "
          f"{TP_LOSS_TOL}, each other <= one process's bf16 against its fp32: {fmt(noise)}); every rank's gathered "
          f"state the same", flush=True)
    print(f"[{tag}] bytes per rank against one process's params {one['param_bytes'] / 1e6:.2f} MB, moments "
          f"{one['moment_bytes'] / 1e6:.2f} MB, EMA {one['ema_bytes'] / 1e6:.2f} MB: {per_rank} | {smi}", flush=True)
    first = " (its one step, warm-up included)" if len(r0["losses"]) == 1 else ""
    print(f"[{tag}] bf16 per rank step{first} {r0['ms']:.3f} ms, fp32 {ranks[0]['float32']['ms']:.3f} ms (one process "
          f"{one['ms']:.3f} and {ref['float32']['ms']:.3f} ms; {note}); bf16 collectives a step {summary}, by "
          f"(kind, group, size) {groups}, the largest {biggest / 1e6:.3f} MB (the params "
          f"{one['param_bytes'] / 1e6:.2f} MB); rows 1-4 launches {_fmt(want)} per rank step at "
          f"{HEADS // TP_SIZE} heads | {smi}", flush=True)
    _print_inventory(tag, "bf16, one rank step", inv, one["param_bytes"])


def phase_tensor_parallel(smi: str) -> tuple[dict, list[dict]]:
    """Phase 36 (docstring). Returns the rows 1-4 launches of (a)'s rank 0
    (3 steps) and (c)'s rank 0 (one generate), by direction and n, and
    (a)'s ranks' results, which hold phase 40's audit."""
    import numpy as np
    import torch

    from tinyedm_tpu_torch.configs import model_from_config
    from tinyedm_tpu_torch.parallel.audit import inventory_summary

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) a 1 x 2 grid, 3 steps with dropout, against one process
        ref = {dt: _tp_steps("cuda", None, False, TP_STEPS, True, dt) for dt in TP_DTYPES}
        t0 = time.perf_counter()
        a = _spawn_tp("a", TP_SIZE, "gloo", tmp)
        _tp_gates("36 tensor parallel (a) 1 x 2", a, ref, smi)
        print(f"[36 tensor parallel] (a) spawned ranks ran {time.perf_counter() - t0:.1f} s, start-up, (c)'s "
              f"generate and phase 40's audit included", flush=True)
        # (b) a 2 x 2 grid with ZeRO-1, one step, draws injected
        ref_b = {dt: _tp_steps("cuda", None, False, 1, False, dt) for dt in TP_DTYPES}
        _tp_gates("36 tensor parallel (b) 2 x 2 zero1", _spawn_tp("b", 2 * TP_SIZE, "gloo", tmp), ref_b, smi)
        del ref_b
        torch.cuda.empty_cache()
        # (c) ImageNet-512 generate --model_parallel 2 against one process
        one = _tp_generate(str(tmp / "gen-one"), 1)
        torch.cuda.empty_cache()
        c = [r["c"] for r in a]  # (a)'s ranks ran it
        ours, theirs = c[0]["samples"], one["samples"]
        if not (np.isfinite(ours).all() and ours.shape == theirs.shape == (TP_GEN, 64, 64, 4)):
            fail(f"36 (c): samples {ours.shape} finite {np.isfinite(ours).all()}")
        close = np.abs(ours - theirs) <= TP_GEN_TOL + TP_GEN_TOL * np.abs(theirs)
        pngs = sorted(x.name for x in (tmp / "gen-tp-gloo").glob("*.png"))
        if not close.all() or c[0]["written"] != list(range(TP_GEN)) or c[1]["written"] or len(pngs) != TP_GEN:
            fail(f"36 (c): {int((~close).sum())} values off rtol = atol = {TP_GEN_TOL}; rows written "
                 f"{[r['written'] for r in c]}, PNGs {pngs}")
        forwards = 2 * TP_GEN_STEPS - 1
        want = {(d, n): k * forwards for n, k in PATHS["imagenet512"]["calls"].items() for d in ("fwd",)}
        if any(r["launches"] != want for r in c):
            fail(f"36 (c): rows 1-2 launches {[r['launches'] for r in c]}, expected {want}")
        summary = inventory_summary(c[0]["inventory"])
        print(f"[36 tensor parallel] (c) generate --model_parallel 2 (the CLI's main), imagenet512 at full width, "
              f"Heun num_steps {TP_GEN_STEPS} ({forwards} forwards), {TP_GEN} latents at batch {TP_GEN}, 2 heads a "
              f"rank: samples against one process max abs {float(np.abs(ours - theirs).max()):.3g}, relative L2 "
              f"{rel_l2(torch.from_numpy(ours), torch.from_numpy(theirs)):.3g} (rtol = atol = {TP_GEN_TOL}); "
              f"{TP_GEN} PNGs written once, by model rank 0; rows 1-2 launches {_fmt(want)} a rank; collectives "
              f"{summary}; {max(r['seconds'] for r in c):.2f} s a rank (host-staged gloo, NOT NCCL's speed), one "
              f"process {one['seconds']:.2f} s | {smi}", flush=True)
        with torch.device("meta"):
            in512_bytes = 4 * sum(x.numel() for x in model_from_config("imagenet512").parameters())
        _print_inventory("36 tensor parallel", "(c) generate on rank 0", c[0]["inventory"], in512_bytes, rows=False)
        # (d) NCCL over two cards
        if torch.cuda.device_count() >= 2:
            _tp_gates("36 tensor parallel (d) nccl 1 x 2", _spawn_tp("a", TP_SIZE, "nccl", tmp), ref, smi)
        else:
            print(f"[36 tensor parallel] (d) NCCL over two cards did not run: this machine has "
                  f"{torch.cuda.device_count()} card", flush=True)
    return {"cifar10_tp": {k: v * TP_STEPS for k, v in a[0]["bfloat16"]["launches"][0].items()},
            "imagenet512_tp": c[0]["launches"]}, a


# ---------------------------------------------------------------------------
# phase 40: the collective-audit CLI (tinyedm_tpu_torch/collective_audit.py)
# ---------------------------------------------------------------------------
AUDIT_ARGS = dict(config="cifar10", batch=TP_GLOBAL, model_parallel=TP_SIZE, sampler=True)


def _audit_in_rank() -> dict:
    """``collective_audit.audit(**AUDIT_ARGS)`` on this rank, with the
    (direction, n, heads) of every rows 1-4 launch it made."""
    from tinyedm_tpu_torch import collective_audit
    from tinyedm_tpu_torch.ops import fused_attention as fa

    shapes = set()
    real_fwd, real_bwd = fa.cosine_attention_qkv_cuda, fa.cosine_attention_qkv_bwd_cuda

    def fwd(qkv, num_heads):
        shapes.add(("fwd", qkv.shape[1], num_heads))
        return real_fwd(qkv, num_heads)

    def bwd(qkv, g, o, num_heads):
        shapes.add(("bwd", qkv.shape[1], num_heads))
        return real_bwd(qkv, g, o, num_heads)

    fa.cosine_attention_qkv_cuda, fa.cosine_attention_qkv_bwd_cuda = fwd, bwd
    try:
        result = collective_audit.audit(**AUDIT_ARGS)
    finally:
        fa.cosine_attention_qkv_cuda, fa.cosine_attention_qkv_bwd_cuda = real_fwd, real_bwd
    return {**result, "shapes": shapes}


def phase_collective_audit(smi: str, tp_ranks: list[dict]) -> None:
    """Phase 40 (docstring). ``tp_ranks``: phase 36 (a)'s ranks' results,
    which hold the audit each ran after (a)'s steps and (c)'s generate; the
    audit's train step must equal (a)'s last bf16 step in summary."""
    import torch

    from tinyedm_tpu_torch import collective_audit
    from tinyedm_tpu_torch.parallel.audit import inventory_summary, wire_bytes

    if torch.cuda.device_count() < 2:
        try:
            collective_audit.parse_args(["--devices", "2"])
        except ValueError as e:
            print(f"[40 collective audit] --devices 2 over NCCL on {torch.cuda.device_count()} card refused: {e}",
                  flush=True)
        else:
            fail("40: --devices 2 over NCCL was not refused on one card")
    ranks = [r["audit"] for r in tp_ranks]
    tp_step = tp_ranks[0]["bfloat16"]["inventories"][-1]
    seconds = max(r["seconds"] for r in ranks)
    r0 = ranks[0]
    train, sampler = r0["programs"]
    forwards = 2 * collective_audit.HEUN_STEPS - 1
    calls = PATHS["cifar10"]["calls"]
    want_train = {(d, n): c for n, c in calls.items() for d in ("fwd", "bwd")}
    want_sampler = {("fwd", n): c * forwards for n, c in calls.items()}
    heads = {h for r in ranks for _, _, h in r["shapes"]}
    bad = []
    if any([p["inventory"] for p in r["programs"]] != [p["inventory"] for p in r0["programs"]] for r in ranks):
        bad.append("the ranks' inventories differ")
    if inventory_summary(train["inventory"]) != inventory_summary(tp_step):
        bad.append(f"train step {inventory_summary(train['inventory'])} != phase 36 (a)'s "
                   f"{inventory_summary(tp_step)}")
    if any(r["programs"][0]["launches"] != want_train or r["programs"][1]["launches"] != want_sampler
           for r in ranks) or heads != {HEADS // TP_SIZE}:
        bad.append(f"rows 1-4 launches {[[p['launches'] for p in r['programs']] for r in ranks]} at heads {heads}, "
                   f"expected {want_train} and {want_sampler} at {HEADS // TP_SIZE}")
    inv = sampler["inventory"]
    if {(c.kind, c.group) for c in inv[:-1]} != {("all_gather", "model")} or inv[-1].kind != "barrier":
        bad.append(f"sampler collectives {inventory_summary(inv)}")
    if max(c.bytes for c in train["inventory"]) >= r0["param_bytes"]:
        bad.append("a train-step collective carries the whole params")
    if bad:
        fail(f"40 collective audit: {'; '.join(bad)}")
    for line in collective_audit.report({**r0, "programs": [train]}).splitlines():
        print(f"[40 collective audit] {line}", flush=True)
    print(f"[40 collective audit] ===== {sampler['name']} =====: {inventory_summary(inv)}; payload total "
          f"{sum(c.bytes for c in inv) / 1e6:.2f} MB, ring-estimate wire bytes a rank "
          f"{sum(wire_bytes(c) for c in inv) / 1e6:.2f} MB a solve ({len(inv)} rows not shown); rows 1-4 launches "
          f"{_fmt(sampler['launches'])}", flush=True)
    print(f"[40 collective audit] collective_audit.audit on 2 ranks sharing the card over gloo, {AUDIT_ARGS}: the "
          f"ranks' inventories equal, the train step's summary phase 36 (a)'s, rows 1-4 at {HEADS // TP_SIZE} heads "
          f"a rank ({_fmt(want_train)} a step, {_fmt(want_sampler)} a solve); {seconds:.1f} s in phase 36 (a)'s "
          f"ranks, after their steps (host-staged gloo, NOT NCCL's speed) | {smi}", flush=True)


# phase 38: validate_learning's two runs, and rows 2 and 4 at its shapes
# (attention at 8x8: 2 heads of 48, the training batch 256, CFG's stacked 512)
VL_RUNS = (("default", {}), ("guided", dict(guided=True, autoguided=True, solver="dpmpp2m")))
VL_STEPS = 600  # train steps a run (the JAX experiment's 1500 cut for time; the autoguide is step 300's EMA)
VL_LAYERS, VL_HEADS = 2, 2  # attention layers a forward (EncA, DecA); heads a layer
VL_FWD_SHAPES = [("validate", 256, 64, 48, f"{FUSED_FWD}:253"), ("validate_cfg", 512, 64, 48, f"{FUSED_FWD}:253")]
VL_BWD_SHAPES = [("validate", 256, 64, 48, f"{FUSED_FWD}:305")]
VL_TIMEOUT = 900  # seconds for the spawned run, start-up included
# phase 39: the soak across both lr boundaries, stopped at 300 and resumed to 400
SOAK_RAMPUP, SOAK_STEADY, SOAK_DECAY, SOAK_CKPT = 50, 100, 50, 100
SOAK_ARGS = ["--rampup", str(SOAK_RAMPUP), "--steady", str(SOAK_STEADY), "--decay", str(SOAK_DECAY), "--ckpt_every",
             str(SOAK_CKPT), "--tag", "chip"]
SOAK_STOP, SOAK_TOTAL = 150, 200  # stopped at the steady -> decay boundary, resumed in the decay phase


def phase_api(smi: str) -> None:
    """Phase 37 (docstring)."""
    import torch

    from tinyedm_tpu_torch import (
        DenoiserWrapper,
        DeterministicSolver,
        Diffuser,
        MultistepSolver,
        StochasticSolver,
    )
    from tinyedm_tpu_torch.diffusion import protocols
    from tinyedm_tpu_torch.ops.dropout import mp_dropout
    from tinyedm_tpu_torch.ops.mp import in_dtype, mp_cat
    from tinyedm_tpu_torch.validate_learning import build_model

    class Net(torch.nn.Module):  # tests/test_reference_parity.py's parameter-free net
        def forward(self, cx, c_noise, emb):
            return cx * (1.0 + c_noise.reshape(-1, 1, 1, 1)) + 0.25 * cx**2 * emb.mean(-1).reshape(-1, 1, 1, 1)

    model = build_model(True, "cuda")
    wrapper = DenoiserWrapper(Net(), 0.5).cuda()
    objects = {"EDMEmbedding": [model.embedding], "EDMDenoiser": [model.denoiser, wrapper],
               "EDMDiffuser": [Diffuser()],
               "EDMSolver": [DeterministicSolver(), MultistepSolver(), StochasticSolver()]}
    for name, objs in objects.items():
        bad = [type(o).__name__ for o in objs if not isinstance(o, getattr(protocols, name))]
        if bad:
            fail(f"37 api: {bad} do not satisfy {name}")
    if model.embedding.embedding_dim != 64 or next(model.parameters()).device.type != "cuda":
        fail(f"37 api: embedding_dim {model.embedding.embedding_dim}, model on {next(model.parameters()).device}")
    del model

    g = torch.Generator().manual_seed(0)
    x = torch.randn((256, 1, 16, 16), generator=g)
    sigma = torch.exp(torch.randn((256,), generator=g) * 1.2 - 1.2)
    emb = torch.randn((256, 64), generator=g)
    cpu = wrapper(x, sigma, emb)
    card = wrapper(x.cuda(), sigma.cuda(), emb.cuda())
    wrap_err = float((card.cpu() - cpu).abs().max())
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=1e-6,
                               msg=lambda m: f"37 api: DenoiserWrapper card vs CPU: {m}")

    cat_errs = {}
    a, b = torch.randn((256, 64, 16, 16), generator=g), torch.randn((256, 32, 16, 16), generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        ref = mp_cat(a.to(dtype), b.to(dtype), dim=1, t=0.3)
        out = mp_cat(a.to(dtype).cuda(), b.to(dtype).cuda(), dim=1, t=0.3).cpu()
        cat_errs[str(dtype).split(".")[-1]] = err = float((out.float() - ref.float()).abs().max())
        if out.dtype != dtype or out.shape != (256, 96, 16, 16) or err > (1e-6 if dtype == torch.float32 else 0.0):
            fail(f"37 api: mp_cat {dtype} card vs CPU max abs {err}, {out.dtype} {tuple(out.shape)}")

    drop = {}
    ones = torch.ones((4096, 4096), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        y = mp_dropout(ones.to(dtype), 0.13, torch.Generator(device="cuda").manual_seed(1))
        again = mp_dropout(ones.to(dtype), 0.13, torch.Generator(device="cuda").manual_seed(1))
        kept = y != 0
        keep = float(kept.float().mean())
        exact = bool((y[kept] == in_dtype(1.0 / 0.87, dtype)).all())
        if not (abs(keep - 0.87) < 1e-3 and exact and torch.equal(y, again) and y.dtype == dtype):
            fail(f"37 api: mp_dropout {dtype}: keep {keep}, survivors exact {exact}, same mask "
                 f"{torch.equal(y, again)}")
        drop[str(dtype).split(".")[-1]] = keep
    if mp_dropout(ones, 0.0, None) is not ones:
        fail("37 api: mp_dropout at rate 0 is not the identity")
    print(f"[37 api] Protocols hold for the card-built {', '.join(objects)} objects (Embedding.embedding_dim "
          f"64); DenoiserWrapper card vs CPU fp32 max abs {wrap_err:.3g} (rtol = atol = 1e-6); mp_cat NCHW t 0.3 "
          f"card vs CPU max abs {cat_errs}; mp_dropout rate 0.13 on 4096 x 4096: keep fraction {drop} (0.87 "
          f"+- 1e-3), every survivor exactly 1/0.87 in its dtype, the same mask from the same seed | {smi}",
          flush=True)


def _stage_diffs(marks: list) -> dict:
    """{stage: (launches, forwards by batch)} from the cumulative counts that
    validate_learning's stage callback recorded."""
    out, prev_l, prev_f = {}, {}, {}
    for name, launches, forwards in marks:
        out[name] = ({k: v - prev_l.get(k, 0) for k, v in launches.items() if v != prev_l.get(k, 0)},
                     {k: v - prev_f.get(k, 0) for k, v in forwards.items() if v != prev_f.get(k, 0)})
        prev_l, prev_f = launches, forwards
    return out


def _vl_run(tag: str) -> dict:
    """One validate_learning run of ``VL_RUNS``, its lines tagged: the
    result, with the launches and EDM forwards of each stage."""
    from tinyedm_tpu_torch import validate_learning as vl
    from tinyedm_tpu_torch.ops import fused_attention as fa

    marks = []
    with _edm_forwards() as by_batch:
        _clear_counts()
        t0 = time.perf_counter()
        result = vl.run(device="cuda", steps=VL_STEPS, **dict(VL_RUNS)[tag],
                        log=lambda line: print(f"[38 {tag}] {line}", flush=True),
                        stage=lambda name: marks.append((name, dict(fa.launch_counts), dict(by_batch))))
        result["seconds"] = time.perf_counter() - t0
    result.update(stages=_stage_diffs(marks), flash=_flash_calls())
    return result


def _vl_child(tag: str, out: str) -> None:
    """Phase 38's spawned process: ``_vl_run(tag)``, saved to ``out``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    resolve_device("cuda")  # fp32 without TF32
    torch.save(_vl_run(tag), out)


def phase_validate_learning(smi: str) -> list[dict]:
    """Phase 38 (docstring). The two runs go at once, the guided one in a
    spawned process: each is bound by its own host thread, not the card.
    Returns rows 2 and 4's entries at its shapes."""
    import multiprocessing

    import torch

    from tinyedm_tpu_torch import validate_learning as vl

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "guided.pt"
        child = multiprocessing.get_context("spawn").Process(target=_vl_child, args=("guided", str(out)))
        child.start()
        t0 = time.perf_counter()
        runs = {"default": _vl_run("default")}
        child.join(max(1.0, VL_TIMEOUT - (time.perf_counter() - t0)))
        if child.is_alive():
            child.kill()
            child.join(30)
        if child.exitcode != 0 or not out.exists():
            fail(f"38 validate_learning guided: the spawned run ended with exit code {child.exitcode}")
        runs["guided"] = torch.load(out, weights_only=False)
    wall = time.perf_counter() - t0
    for tag, options in VL_RUNS:
        result = runs[tag]
        if not result["ok"]:
            fail(f"38 validate_learning {tag}: RESULT: FAIL")
        stages = result["stages"]
        solver = options.get("solver", "heun")
        forwards = vl.SOLVER_STEPS if solver == "dpmpp2m" else 2 * vl.SOLVER_STEPS - 1
        b = vl.N_PER * vl.NUM_CLASSES
        want = {"train": ({("fwd", 64): VL_LAYERS * VL_STEPS, ("bwd", 64): VL_LAYERS * VL_STEPS}, {}),
                "sample": ({("fwd", 64): VL_LAYERS * forwards}, {b: forwards})}
        if options.get("guided"):
            want["cfg2"] = ({("fwd", 64): VL_LAYERS * forwards}, {2 * b: forwards})
        for scale in vl.AUTO_SCALES if options.get("autoguided") else ():
            want[f"auto{scale}"] = ({("fwd", 64): 2 * VL_LAYERS * forwards}, {b: 2 * forwards})
        got = {k: v for k, v in stages.items() if k != "cfg2-interval"}
        if got != want or result["flash"]:
            fail(f"38 validate_learning {tag}: launches and forwards by stage {got}, expected {want}; flash "
                 f"{result['flash']}")
        if options.get("guided"):  # the interval's stacked forwards inside (0.1, 2.0], plain ones outside
            launches, by = stages["cfg2-interval"]
            if not (sum(by.values()) == forwards and by.get(2 * b) and by.get(b)
                    and launches == {("fwd", 64): VL_LAYERS * forwards}):
                fail(f"38 validate_learning {tag}: cfg2-interval launched {launches} over forwards {by}")
        base = ", ".join(f"{own:.3f}/{other:.3f}" for own, other in result["base"])
        guided = "; ".join(f"{g}: " + ", ".join(f"{r[0]:.3f} (margin {r[2]:.3f} vs {r[3]:.3f})" for r in rows)
                           for g, rows in result["guided"].items())
        solves = ", ".join(f"{k} {v:.2f} s ({sum(stages[k][1].values())} forwards {stages[k][1]})"
                           for k, v in result["sample_s"].items())
        print(f"[38 validate_learning] {tag} ({solver}-{vl.SOLVER_STEPS}{', --guided --autoguided' if options else ''}"
              f"{', a spawned process' if tag == 'guided' else ''}): RESULT: PASS; own/best-other sims by class "
              f"{base}" + (f"; {guided}" if guided else "")
              + f"; {VL_STEPS} steps of {vl.BATCH} in {result['train_s']:.2f} s ({result['ms_per_step']:.3f} ms a "
              f"step, {vl.BATCH / result['ms_per_step'] * 1e3:.1f} samples/s, beside the other run), final loss "
              f"{result['final_loss']:.4f}; solves {solves}; rows 2 and 4 launched {VL_LAYERS} + {VL_LAYERS} a train "
              f"step ({_fmt(stages['train'][0])} in all), {VL_LAYERS} a forward; {result['seconds']:.1f} s | {smi}",
              flush=True)
    print(f"[38 validate_learning] both runs at once in {wall:.1f} s, the spawned process's start-up included",
          flush=True)
    torch.cuda.empty_cache()

    entries = []
    for config, b, n, hd, replaces in VL_FWD_SHAPES:
        e = _fwd_shape("38 validate_learning", config, b, n, hd, VL_HEADS, replaces)
        if config == "validate":  # every forward of the default run: its training and its Heun-18 solve
            e["launches"] = sum(st[0].get(("fwd", n), 0) for st in runs["default"]["stages"].values())
            e["path"] = f"validate_learning default run: {VL_STEPS} train steps at 256 and Heun-18 at 256"
            e["launches_per_train_step"] = VL_LAYERS
        else:  # the CFG solves of the guided run (the interval's forwards outside it at 256 included)
            e["launches"] = sum(runs["guided"]["stages"][s][0].get(("fwd", n), 0) for s in ("cfg2", "cfg2-interval"))
            e["path"] = "validate_learning --guided: CFG DPM++(2M)-18, stacked forwards at 512, plain and on (0.1, 2.0]"
        entries.append(e)
    for config, b, n, hd, replaces in VL_BWD_SHAPES:
        e = _bwd_shape("38 validate_learning", config, b, n, hd, VL_HEADS, replaces)
        e["launches"] = runs["default"]["stages"]["train"][0][("bwd", n)]
        e["path"] = f"validate_learning default run: {VL_STEPS} train steps at 256"
        e["launches_per_train_step"] = VL_LAYERS
        entries.append(e)
    for e in entries:
        del e["config"], e["n"]
    return entries


def phase_soak(smi: str, bare: dict, loop_ms: float) -> None:
    """Phase 39 (docstring). ``bare``: phase 9's result; ``loop_ms``: phase
    24's loop ms/step."""
    from tinyedm_tpu_torch import soak

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        run = Path("runs") / "soak_chip"
        calls = []
        for args in (["--stop_at", str(SOAK_STOP)], ["--resume"]):
            t0 = time.perf_counter()
            rc = soak.main(SOAK_ARGS + args)
            seconds = time.perf_counter() - t0
            if rc != 0:
                fail(f"39 soak {' '.join(args)}: exit code {rc} (RESULT: FAIL)")
            calls.append((json.loads((run / "summary.json").read_text()), seconds))
        records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        ckpts = sorted(int(p.name) for p in (run / "checkpoints").iterdir())
    (fresh, t_fresh), (resumed, t_resumed) = calls
    steps = [r["step"] for r in records]
    off = [r for r in records
           if not math.isclose(r["lr"], soak.ref_lr(r["step"], 0.02, SOAK_RAMPUP, SOAK_STEADY), rel_tol=5e-5)
           or not math.isfinite(r["train_loss"])]
    if (fresh["steps"], fresh["resumed_at"], resumed["steps"], resumed["resumed_at"]) != (
            SOAK_STOP, None, SOAK_TOTAL, SOAK_STOP) or ckpts != [SOAK_CKPT, SOAK_STOP, SOAK_TOTAL] or off \
            or not fresh["final_loss"] < fresh["first_loss"] or steps != sorted(set(steps)) \
            or not {b + d for b in (SOAK_RAMPUP, SOAK_RAMPUP + SOAK_STEADY) for d in (-2, 2)} | {SOAK_TOTAL - 1} \
            <= set(steps):
        fail(f"39 soak: summaries {fresh} {resumed}, checkpoints {ckpts}, logged steps {steps}, off the formula {off}")
    print(f"[39 soak] cifar10.yaml at full width (35.62 M parameters), rampup {SOAK_RAMPUP} / steady {SOAK_STEADY} / "
          f"decay {SOAK_DECAY}, "
          f"stopped at {SOAK_STOP} and resumed to {SOAK_TOTAL} (decay phase): RESULT: PASS twice; {len(records)} "
          f"logged steps on the lr formula (rel 5e-5), losses finite, first {fresh['first_loss']:.4f} -> "
          f"{fresh['final_loss']:.4f} at {SOAK_STOP - 1}, {resumed['final_loss']:.4f} at {SOAK_TOTAL - 1}; "
          f"checkpoints {ckpts}; {fresh['samples_per_s']:.1f} and {resumed['samples_per_s']:.1f} samples/s "
          f"(phase 9's bare step {bare['samples_per_s']:.1f}, phase 24's loop "
          + (f"{256 / loop_ms * 1e3:.1f}" if loop_ms else "not run") + f"); {t_fresh:.1f} s and "
          f"{t_resumed:.1f} s | {smi}", flush=True)


def _wn_shapes(config: str) -> list:
    """Every (weight shape, compute dtype) of the config's weight-normed
    layers, from the model built on the meta device."""
    import torch

    from tinyedm_tpu_torch.configs import model_from_config
    from tinyedm_tpu_torch.models.layers import WNConv, WNLinear

    with torch.device("meta"):
        model = model_from_config(config)
    return sorted({(tuple(m.weight.shape), m.dtype) for m in model.modules() if isinstance(m, (WNConv, WNLinear))},
                  key=str)


def _wn_gap(out, ref) -> tuple[float, int]:
    """(worst gap, elements unequal) of the kernel's output against the
    plain version's: bf16 ulps of ref, or the fp32 relative gap."""
    import torch

    unequal = int((out != ref).sum())
    ref32 = ref.float()
    if out.dtype == torch.bfloat16:
        mag = ref32.abs().clamp_min(torch.finfo(torch.float32).tiny)
        return float(((out.float() - ref32).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max()), unequal
    return float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max()), unequal


def _wn_check(w, scale: float, dtype, what: str) -> tuple[float, int]:
    import torch

    from tinyedm_tpu_torch.ops import mp

    before = mp.weight_norm_cast.launches
    out = mp.weight_norm_cast(w, scale, dtype)
    torch.cuda.synchronize()
    if mp.weight_norm_cast.launches != before + 1:
        fail(f"{what}: weight_norm_cast did not launch its kernel once")
    gap, unequal = _wn_gap(out, mp.weight_norm_cast_plain(w, scale, dtype))
    limit = 1.0 if dtype == torch.bfloat16 else 2.0**-20
    if not gap <= limit:
        fail(f"{what}: kernel vs plain gap {gap} > {limit}")
    return gap, unequal


def _wn_bwd_check(w, g, scale: float, what: str) -> float:
    """The backward kernel's worst gap against the plain backward, as a
    share of the largest plain value of its row; fails beyond 2^-20."""
    import torch

    from tinyedm_tpu_torch.ops import mp

    before = mp.weight_norm_cast.bwd_launches
    out = mp.weight_norm_cast_bwd(w, g, scale)
    torch.cuda.synchronize()
    if mp.weight_norm_cast.bwd_launches != before + 1:
        fail(f"{what}: weight_norm_cast_bwd did not launch its kernel once")
    ref = mp.weight_norm_cast_bwd_plain(w, g, scale).reshape(w.shape[0], -1)
    diff = (out.reshape(ref.shape) - ref).abs().amax(dim=1)
    gap = float((diff / ref.abs().amax(dim=1).clamp_min(1e-30)).max())
    if not gap <= 2.0**-20:
        fail(f"{what}: backward kernel vs plain gap {gap} of its row's largest value > 2^-20")
    return gap


def _wn_profiled_ms(run, calls: int, key: str, what: str) -> float:
    """Device ms a call from a profile of ``run()``, which makes ``calls``
    calls: the time of every device event, read only from a profile that
    holds the same positive number of events named ``key`` for each call
    and a device time above 0. The profiler can lose a window's events, so
    it profiles up to five times before the phase fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events() if e.device_type() != DeviceType.CPU]
        named, device_ns = sum(key in e.name() for e in events), sum(e.duration_ns() for e in events)
        if named > 0 and named % calls == 0 and device_ns > 0:
            return device_ns / 1e6 / calls
        seen.append((named, device_ns))
    fail(f"{what}: no profile held {key} for each of its {calls} calls (events named, device ns: {seen})")


def _wn_times(fn, w, key: str, what: str) -> tuple[float, float]:
    """(device ms, host ms) a call of ``fn(w_i)``, cycling over copies of
    ``w`` that together pass the 50 MB L2 cache (in a forward each weight
    comes from memory): the device time of its kernels in a profile that
    holds its kernel ``key`` for each call (``_wn_profiled_ms``), and the
    CUDA-event time of back-to-back calls, which the host's dispatch bounds
    where the kernels are short."""
    copies = [w.clone() for _ in range(max(2, math.ceil(128e6 / (w.numel() * 4))))]
    state = {"i": 0}

    def call():
        fn(copies[state["i"] % len(copies)])
        state["i"] += 1

    host_ms = time_ms(call, iters=len(copies), reps=3)

    def each():
        for c in copies:
            fn(c)

    return _wn_profiled_ms(each, len(copies), key, what), host_ms


def _wn_bwd_times(fn, w, g, key: str, what: str) -> tuple[float, float]:
    """(device ms, host ms) of the backward of ``fn(w_i)`` through autograd
    from ``g``, cycling over copies of ``w`` and ``g`` that together pass
    the L2 cache, as ``_wn_times``: the graphs are built first, each
    backward keeps its graph."""
    import torch

    n = max(2, math.ceil(128e6 / (w.numel() * (4 + g.element_size()))))
    copies = [w.clone().requires_grad_(True) for _ in range(n)]
    cotangents = [g.clone() for _ in range(n)]
    outs = [fn(c) for c in copies]
    state = {"i": 0}

    def call():
        i = state["i"] % n
        torch.autograd.grad(outs[i], copies[i], cotangents[i], retain_graph=True)
        state["i"] += 1

    host_ms = time_ms(call, iters=n, reps=3)

    def each():
        for _ in range(n):  # each copy once
            call()

    return _wn_profiled_ms(each, n, key, what), host_ms


def _wn_truncating(w, scale: float, dtype):
    """The Heun-2 gate's control, a wrong kernel: the composite's fp32
    weight cast to bf16 by truncation instead of rounding to nearest."""
    import torch

    from tinyedm_tpu_torch.ops import mp

    y = mp.weight_norm_cast_plain(w, scale, torch.float32)
    if dtype == torch.bfloat16:
        y = (y.view(torch.int32) & -65536).view(torch.float32)
    return y.to(dtype)


def phase_weight_norm() -> list[dict]:
    """Phase 41 (the module docstring). Returns the kernel line's entries;
    main() fills in their launches from phases 8, 9, 11 and 12."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.generate import make_solver
    from tinyedm_tpu_torch.models import layers
    from tinyedm_tpu_torch.ops import mp
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    tag = "41 weight norm"
    g = torch.Generator(device="cuda").manual_seed(41)
    for config in ("cifar10", "imagenet512"):
        worst, unequal, total, worst32 = 0.0, 0, 0, 0.0
        shapes = _wn_shapes(config)
        for shape, dtype in shapes:
            w = torch.randn(shape, generator=g, device="cuda") * 1.7
            gap, n = _wn_check(w, 1.0 / math.sqrt(math.prod(shape[1:])), dtype, f"{config} {shape} {dtype}")
            if dtype == torch.bfloat16:
                worst, unequal, total = max(worst, gap), unequal + n, total + w.numel()
            else:
                worst32 = max(worst32, gap)
        print(f"[{tag}] {config}: {len(shapes)} weight shapes, kernel vs plain: bf16 worst {worst:.0f} ulp, "
              f"{unequal} of {total} elements unequal ({unequal / total:.2e}, <= 1e-3), fp32 worst relative "
              f"{worst32:.3g} (<= 2^-20)", flush=True)
        if unequal > 1e-3 * total:
            fail(f"{config}: {unequal} of {total} bf16 elements differ from the plain version")
        worst_bwd = {}
        for shape, _ in shapes:
            w = torch.randn(shape, generator=g, device="cuda") * 1.7
            for gdtype in (torch.bfloat16, torch.float32):
                cot = torch.randn(shape, generator=g, device="cuda").to(gdtype)
                gap = _wn_bwd_check(w, cot, 1.0 / math.sqrt(math.prod(shape[1:])), f"{config} {shape} g {gdtype}")
                worst_bwd[gdtype] = max(worst_bwd.get(gdtype, 0.0), gap)
        print(f"[{tag}] {config}: backward kernel vs plain at the {len(shapes)} shapes, worst gap of a row's largest "
              f"value {worst_bwd[torch.bfloat16]:.3g} from bf16 gradients, {worst_bwd[torch.float32]:.3g} from "
              f"fp32 (<= 2^-20)", flush=True)
    for shape in [(4, 20000), (2, 3000, 3, 3), (7, 45), (3, 1)]:
        w = torch.randn(shape, generator=g, device="cuda")
        flat = torch.empty(w.numel() + 1, device="cuda")
        view = flat[1:].view(shape)
        view.copy_(w)
        for dtype in (torch.bfloat16, torch.float32):
            _wn_check(w, 0.37, dtype, f"{shape} {dtype}")
            _wn_check(view, 0.37, dtype, f"{shape} {dtype} at an odd element offset")
    for shape in [(4, 20000), (2, 3000, 3, 3), (7, 45), (6, 257, 1, 1), (4, 769), (3, 1)]:
        w = torch.randn(shape, generator=g, device="cuda")
        flat = torch.empty(w.numel() + 1, device="cuda")
        view = flat[1:].view(shape)
        view.copy_(w)
        for gdtype in (torch.bfloat16, torch.float32):
            cot = torch.randn(shape, generator=g, device="cuda").to(gdtype)
            gflat = torch.empty(cot.numel() + 1, dtype=gdtype, device="cuda")
            gview = gflat[1:].view(shape)
            gview.copy_(cot)
            _wn_bwd_check(w, cot, 0.37, f"backward {shape} g {gdtype}")
            _wn_bwd_check(view, gview, 0.37, f"backward {shape} g {gdtype} at an odd element offset")
    print(f"[{tag}] rows of 20,000 and 27,000 (beyond the models' longest), 769, 257, 45 (backward) and 1, aligned and "
          f"at an odd element offset: ok", flush=True)

    entries = []
    for config, shape in WN_TIMED:
        dtype = torch.float32 if len(shape) == 2 else torch.bfloat16
        w = torch.randn(shape, generator=g, device="cuda")
        scale = 1.0 / math.sqrt(math.prod(shape[1:]))
        gap, _ = _wn_check(w, scale, dtype, f"timed {shape}")
        what = f"timed {shape}"
        ms, call_ms = _wn_times(lambda x: mp.weight_norm_cast(x, scale, dtype), w, "weight_norm_cast_kernel", what)
        plain_ms, plain_call_ms = _wn_times(lambda x: mp.weight_norm_cast_plain(x, scale, dtype), w,
                                            "reduce_kernel", f"{what} composite")
        nbytes = w.numel() * (4 + torch.finfo(dtype).bits // 8)
        bound_ms, bound_by = _bound(nbytes, 0, "float32")
        name = str(dtype).split(".")[-1]
        print(f"[{tag}] weight_norm_cast {config} {'x'.join(map(str, shape))} -> {name}: kernel {ms:.4f} ms on "
              f"the card ({call_ms:.4f} ms a call back to back), plain {plain_ms:.4f} ms ({plain_call_ms:.4f}), "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB)", flush=True)
        entries.append(_entry(f"weight_norm_cast[{config} {'x'.join(map(str, shape))} {name}]", "weight_norm.cu",
                              "none (XLA fused the composite under jit)", gap, ms, plain_ms, bound_ms, bound_by,
                              None, call_ms=call_ms, plain_call_ms=plain_call_ms, config=config))
        # the backward from a gradient in the layer's dtype, each route through autograd
        cot = torch.randn(shape, generator=g, device="cuda").to(dtype)
        gap = _wn_bwd_check(w, cot, scale, f"timed backward {shape}")
        ms, call_ms = _wn_bwd_times(lambda x: mp._WeightNormCast.apply(x, scale, dtype), w, cot,
                                    "weight_norm_cast_bwd_kernel", f"{what} backward")
        plain_ms, plain_call_ms = _wn_bwd_times(lambda x: mp.weight_norm_cast_plain(x, scale, dtype), w, cot,
                                                "reduce_kernel", f"{what} composite backward")
        nbytes = w.numel() * (8 + cot.element_size())
        bound_ms, bound_by = _bound(nbytes, 0, "float32")
        print(f"[{tag}] weight_norm_cast_bwd {config} {'x'.join(map(str, shape))} from {name}: kernel {ms:.4f} ms on "
              f"the card ({call_ms:.4f} ms a backward back to back), composite {plain_ms:.4f} ms "
              f"({plain_call_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB)", flush=True)
        entries.append(_entry(f"weight_norm_cast_bwd[{config} {'x'.join(map(str, shape))} {name}]", "weight_norm.cu",
                              "none (XLA fused the composite's gradient under jit)", gap, ms, plain_ms, bound_ms,
                              bound_by, None, call_ms=call_ms, plain_call_ms=plain_call_ms, config=config))

    # the kernel's route, the composite's and the control's, cuDNN
    # deterministic: the same route twice gives the same samples, so the
    # effective weights are all that differs between two routes
    routes = {"kernel": mp.weight_norm_cast, "composite": mp.weight_norm_cast_plain, "truncating": _wn_truncating}
    solver = make_solver("heun", 2, None, 0.0, 1.0, 0.0, float("inf"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for config in ("cifar10", "imagenet512"):
            p = PATHS[config]
            model = _seeded(config)
            layers_run = _wn_layers_run(model)
            weights = [m for name, m in model.named_modules()
                       if isinstance(m, layers._WeightNormed) and not name.startswith("u.")]
            unequal = {torch.bfloat16: [0, 0, 0.0], torch.float32: [0, 0, 0.0]}  # unequal, of, worst gap
            with torch.inference_mode():
                for m in weights:
                    gap, n = _wn_gap(mp.weight_norm_cast(m.weight, m.scale, m.dtype),
                                     mp.weight_norm_cast_plain(m.weight, m.scale, m.dtype))
                    tally = unequal[m.dtype]
                    tally[:] = tally[0] + n, tally[1] + m.weight.numel(), max(tally[2], gap)
            (b_n, b_of, b_gap), (f_n, f_of, f_gap) = unequal[torch.bfloat16], unequal[torch.float32]
            channels = model.denoiser.conv_in.weight.shape[1] - 1
            x0 = torch.randn((p["batch"], channels, p["side"], p["side"]), generator=g, device="cuda")
            labels = (torch.randint(0, p["classes"], (p["batch"],), generator=g, device="cuda")
                      if p["classes"] else None)
            results, seconds = {}, {}
            for route in ("kernel", "composite", "kernel", "composite", "truncating"):
                layers.weight_norm_cast = routes[route]
                try:
                    before = mp.weight_norm_cast.launches
                    with _edm_forwards() as seen, torch.inference_mode():
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        results.setdefault(route, []).append(solver.solve(model, x0, labels).float())
                        torch.cuda.synchronize()
                        seconds[route] = time.perf_counter() - t  # the last run of the route's
                    launches, forwards = mp.weight_norm_cast.launches - before, sum(seen.values())
                finally:
                    layers.weight_norm_cast = mp.weight_norm_cast
                expected = layers_run * forwards if route == "kernel" else 0
                if launches != expected:
                    fail(f"{config} heun-2, {route} route: {launches} weight_norm_cast launches in {forwards} "
                         f"forwards, expected {expected}")
            (k0, k1), (c0, c1), (trunc,) = results["kernel"], results["composite"], results["truncating"]
            floor_k, floor_c = rel_l2(k1, k0), rel_l2(c1, c0)
            err, control = rel_l2(k1, c1), rel_l2(trunc, c1)
            print(f"[{tag}] {config} heun-2 at batch {p['batch']}, cuDNN deterministic: {forwards} forwards, "
                  f"{layers_run} launches a forward, its effective weights unequal to the composite's in {b_n} of "
                  f"{b_of} bf16 elements (worst {b_gap:.0f} ulp) and {f_n} of {f_of} fp32 (worst relative "
                  f"{f_gap:.3g}); samples rel L2: kernel vs composite route {err:.3g} "
                  f"(<= {WN_SOLVE_LIMIT:g}), kernel twice {floor_k:.3g} and composite twice {floor_c:.3g} "
                  f"(== 0), control (bf16 cast truncating) vs composite {control:.3g} (> {WN_SOLVE_LIMIT:g}); "
                  f"solve {seconds['kernel']:.4f} s vs composite {seconds['composite']:.4f} s "
                  f"({1e3 * seconds['kernel'] / forwards:.2f} vs {1e3 * seconds['composite'] / forwards:.2f} ms a "
                  f"forward)", flush=True)
            if floor_k or floor_c:
                fail(f"{config} heun-2: a route run twice gave other samples (kernel {floor_k}, composite "
                     f"{floor_c})")
            if not err <= WN_SOLVE_LIMIT < control:
                fail(f"{config} heun-2 kernel route vs composite rel L2 {err}, control {control}: the limit "
                     f"{WN_SOLVE_LIMIT} does not lie between them")
            del model, results
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    model, diffuser, opt_cfg, ema_cfg, batch, _ = build_training("cifar10", "cuda", seed=0)
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    images = torch.randn((batch, 3, 32, 32), generator=g, device="cuda")
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    for _ in range(2):
        state, metrics = step(state, (images, None), g, PATHS["cifar10"]["sched"])
    torch.cuda.synchronize()
    launches = mp.weight_norm_cast.launches - before[0], mp.weight_norm_cast.bwd_launches - before[1]
    expected = 2 * sum(isinstance(m, layers._WeightNormed) for m in model.modules())
    print(f"[{tag}] cifar10 train step at {batch}: {launches[0]} weight_norm_cast launches forward and {launches[1]} "
          f"backward in 2 steps (expected {expected} each way), loss {float(metrics['train_loss']):.4g}", flush=True)
    if launches != (expected, expected) or not math.isfinite(float(metrics["train_loss"])):
        fail(f"cifar10 train steps launched weight_norm_cast {launches} times (forward, backward) or lost a finite "
             f"loss")
    del model, state, step
    torch.cuda.empty_cache()
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "tinyedm_tpu_torch" / "csrc").is_dir():
        fail(f"tinyedm_tpu_torch/ not found beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT))
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    resolve_device("cuda")  # fp32 without TF32
    t0 = time.perf_counter()
    lap = Laps()
    smi = phase_environment()
    lap("1")
    phase_build()
    lap("2")
    fwd_entries = phase_kernel_vs_plain()
    lap("3")
    bwd_entries = phase_bwd_kernel_vs_plain()
    lap("4")
    flash_entries = phase_flash_kernels()
    lap("5")
    layer_calls = phase_flash_layer()
    lap("6")
    heun, train_counts, train_results = {}, {}, {}
    for tags, config in ((("7", "8", "9"), "cifar10"), (("10", "11", "12"), "imagenet512")):
        fused, unfused = _seeded_models(config)
        phase_forward(tags[0], config, fused, unfused)
        del unfused
        lap(tags[0])
        heun[config] = phase_sample(tags[1], config, fused, "heun-32", {PATHS[config]["batch"]: 63})
        heun[config]["wn_layers"] = _wn_layers_run(fused)
        if heun[config]["wn_launches"] != 63 * heun[config]["wn_layers"]:
            fail(f"{config} heun-32 launched weight_norm_cast {heun[config]['wn_launches']} times in 63 forwards, "
                 f"expected one a weight-normed layer a forward, {63 * heun[config]['wn_layers']}")
        del fused
        torch.cuda.empty_cache()
        lap(tags[1])
        train_results[config] = phase_train(tags[2], config)
        train_counts[config] = train_results[config]["counts"]
        torch.cuda.empty_cache()
        lap(tags[2])
    block_entries = phase_block_kernels()
    lap("13")
    phase_block_layer()
    lap("14")
    block, unfused = _seeded_models("cifar10", "block")
    phase_forward("15", "cifar10", block, unfused, kind="block_fwd")
    del block, unfused
    torch.cuda.empty_cache()
    lap("15")
    block_train = phase_train("16", "cifar10", fused="block", beside=train_results["cifar10"])
    torch.cuda.empty_cache()
    lap("16")
    wino_entries = phase_winograd()
    lap("17")

    # 18: MNIST (class-conditional): forward, CFG Heun-32 (stacked forwards
    # at twice the batch), training with label dropout, the eval step
    fused, unfused = _seeded_models("mnist")
    phase_forward("18", "mnist", fused, unfused)
    del unfused
    b = PATHS["mnist"]["batch"]
    mnist_cfg = phase_sample("18", "mnist", fused, "cfg heun-32", {2 * b: 63}, guidance_scale=2.0)
    del fused
    torch.cuda.empty_cache()
    train_results["mnist"] = phase_train("18", "mnist", label_dropout=0.1, eval_profiles=0)
    train_counts["mnist"] = train_results["mnist"]["counts"]
    torch.cuda.empty_cache()
    lap("18")
    # 19-20: CIFAR-10 with DPM-Solver++(2M) and with churn
    fused = _seeded("cifar10")
    b = PATHS["cifar10"]["batch"]
    phase_sample("19", "cifar10", fused, "dpm++(2m)-32", {b: 32}, beside=heun["cifar10"], solver="dpmpp2m")
    lap("19")
    phase_sample("20", "cifar10", fused, "churn heun-32", {b: 63}, beside=heun["cifar10"], **CHURN)
    phase_churn_seeds("20", fused)
    del fused
    torch.cuda.empty_cache()
    lap("20")
    # 21-22: ImageNet-512 with CFG on an interval and with autoguidance
    fused = _seeded("imagenet512")
    b = PATHS["imagenet512"]["batch"]
    imagenet_cfg = phase_sample(
        "21", "imagenet512", fused, f"cfg heun-32 on {CFG_INTERVAL}", {2 * b: 14, b: 49}, beside=heun["imagenet512"],
        guidance_scale=2.0, guidance_sigma_min=CFG_INTERVAL[0], guidance_sigma_max=CFG_INTERVAL[1])
    lap("21")
    guide = _seeded("imagenet512", seed=1)
    phase_sample("22", "imagenet512", fused, "autoguidance heun-32", {b: 126}, beside=heun["imagenet512"],
                 guide=guide, guidance_scale=2.0)
    del fused, guide
    torch.cuda.empty_cache()
    lap("22")
    # 23: ImageNet-64 training, the recipe's 3 x 176
    train_results["imagenet"] = phase_train("23", "imagenet", eval_profiles=1)
    train_counts["imagenet"] = train_results["imagenet"]["counts"]
    torch.cuda.empty_cache()
    lap("23")
    # 24: the run loop at CIFAR-10 full width
    loop_per_step, loop_ms = {}, {}
    loop_per_step["cifar10"], loop_ms["cifar10"] = phase_run_loop(smi, train_results["cifar10"])
    torch.cuda.empty_cache()
    lap("24")
    # 25: ImageNet-64 through the CLI at Lightning's 3 x 176
    loop_per_step["imagenet"] = phase_imagenet64_cli(smi, train_results["imagenet"])
    lap("25")
    with tempfile.TemporaryDirectory() as vae_tmp:
        # the seeded sd-vae weights in a fake HF cache (phases 26, 29-31)
        vae_files = write_vae_files(Path(vae_tmp))
        # 26-27 and 31: ImageNet-512 through the CLI on a latpack store, its
        # decoded previews, post-hoc EMA
        with tempfile.TemporaryDirectory() as tmp:
            in512 = phase_imagenet512_cli(smi, train_results["imagenet512"], Path(tmp), vae_files)
            loop_per_step["imagenet512"] = in512["per_step"]
            lap("26 (with 31)")
            phase_posthoc(smi, in512["run"], in512["steps"], Path(tmp))
        lap("27")
        # 28: FID on CIFAR-10
        phase_fid(smi)
        torch.cuda.empty_cache()
        lap("28")
        # 29-30: the VAE at full width, latent extraction through the CLI
        phase_vae(smi, vae_files)
        torch.cuda.empty_cache()
        lap("29")
        with tempfile.TemporaryDirectory() as tmp:
            phase_extract(smi, vae_files, Path(tmp))
    lap("30")
    # 32: reference (Lightning) checkpoints at full width
    with tempfile.TemporaryDirectory() as tmp:
        phase_reference_checkpoints(smi, Path(tmp))
    lap("32")
    # 33: remat, the bf16 island, fused="on"
    knob_entries = phase_knobs(smi)
    torch.cuda.empty_cache()
    lap("33")
    # 34-35: data parallelism and ZeRO-1 over ranks, the CLIs over ranks
    phase_data_parallel(smi, loop_ms["cifar10"], train_results["cifar10"], lap)
    torch.cuda.empty_cache()
    lap("35")
    # 36: tensor parallelism, ranks sharing the card over gloo
    tp_counts, tp_ranks = phase_tensor_parallel(smi)
    torch.cuda.empty_cache()
    lap("36")
    # 37-39: the reference API, validate_learning, the soak
    phase_api(smi)
    lap("37")
    vl_entries = phase_validate_learning(smi)
    torch.cuda.empty_cache()
    lap("38")
    phase_soak(smi, train_results["cifar10"], loop_ms["cifar10"])
    lap("39")
    # 40: the collective-audit CLI's function, run in phase 36 (a)'s ranks
    phase_collective_audit(smi, tp_ranks)
    lap("40")
    wn_entries = phase_weight_norm()
    lap("41")
    dit_entries, dit_calls = phase_flash_dit()
    lap("42")
    flux_entries, flux_calls = phase_flash_flux()
    lap("43")

    # fused kernels: launches of one sampling batch of their path (forward)
    # or of the training run of their config (backward), with the calls per
    # train step
    fwd_counts = {"cifar10": heun["cifar10"]["counts"], "imagenet512": heun["imagenet512"]["counts"],
                  "mnist_cfg": mnist_cfg["counts"], "imagenet512_cfg": imagenet_cfg["counts"]}
    for e in fwd_entries + bwd_entries:
        direction = "bwd" if "bwd" in e["name"] else "fwd"
        key, n = e.pop("config"), e.pop("n")
        if key in tp_counts:  # a rank's heads: phase 36's rank 0
            e["launches"] = tp_counts[key].get((direction, n), 0)
            e["path"] = FWD_PATHS[key]
            if key == "cifar10_tp":
                e["launches_per_train_step"] = e["launches"] // TP_STEPS
            continue
        if direction == "fwd":
            e["launches"] = fwd_counts[key][direction, n]
            e["path"] = FWD_PATHS[key]
        else:
            e["launches"] = train_counts[key][direction, n]
            e["path"] = f"{key} training run"
        if key in train_counts:
            steps = PATHS[key]["warmup"] + PATHS[key]["timed"]
            e["launches_per_train_step"] = train_counts[key][direction, n] // steps
        if key in loop_per_step:
            e["launches_per_loop_step"] = loop_per_step[key][direction, n]
    # flash kernels: the layer check's calls, and the model paths': phase
    # 42's dit_xl2_512 train step (n = 1024, hd 72) and phase 43's
    # flux_dev_1024 train step (n = 4608, hd 128)
    for e in flash_entries:
        direction = "flash_bwd" if "bwd" in e["name"] else "flash_fwd"
        e["launches"] = layer_calls[direction, e.pop("n")]
        e["launches_model_paths"] = sum(v for calls in (dit_calls, flux_calls)
                                        for (kind, _), v in calls.items() if kind == direction)
        e["path"] = "flash layer check (CosineAttention use_pallas=True)"
        e["model_path"] = f"{DIT_STEP_PATH}; {FLUX_STEP_PATH}"
    # block kernels: launches of the CIFAR-10 training run with fused="block"
    block_steps = PATHS["cifar10"]["warmup"] + PATHS["cifar10"]["timed"]
    for e in block_entries:
        key = ("block_bwd" if "bwd" in e["name"] else "block_fwd", e.pop("n"))
        e["launches"] = block_train["counts"][key]
        e["launches_per_train_step"] = e["launches"] // block_steps
        e["path"] = "cifar10 training run, fused=\"block\""
    # weight_norm_cast: launches of one heun-32 sampling batch of its config
    # and per train step; the backward's, of the config's training run
    for e in wn_entries:
        config = e.pop("config")
        fwd, bwd = train_results[config]["wn_launches"]
        if e["name"].startswith("weight_norm_cast_bwd"):
            e["launches"], e["path"] = bwd, f"{config} training run"
        else:
            run = heun[config]
            e["launches"] = run["wn_launches"]
            e["launches_per_forward"] = run["wn_launches"] / run["forwards"]
            e["path"] = run["what"]
        e["launches_per_train_step"] = train_results[config]["wn_per_step"]
    entries = (fwd_entries + bwd_entries + flash_entries + block_entries + wino_entries + knob_entries + vl_entries
               + wn_entries + dit_entries + flux_entries)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
