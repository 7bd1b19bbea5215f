#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (a Hopper H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. builds the CUDA kernels from `if_defense_tpu_torch/csrc/` with nvcc
     (sm_90a) and prints the build time and each kernel's registers;
  2. holds each kernel (B1 repulsion loss, B2 repulsion mask, B3 masked
     repulsion loss, B4 the decoder's three-plane features) against its
     plain PyTorch version at the ConvONet-Opt shapes (B=48, N=Q=1024,
     three 64x64x32 planes), forward and backward, in f32 and bf16, B1-B3
     on random points with duplicates and on a lattice whose rows tie at
     their thresholds, B4 in its defense form (forward + gradient to p,
     points that the normalisation clamps) with two launches bit-identical;
     times each kernel, its plain version and B4's PyTorch yardstick (three
     `F.grid_sample` calls summed, forward + grid gradient) as set out
     below; then the encoder's scatter-mean kernel (`csrc/scatter.cu`,
     which replaces no TPU kernel: on a line of its own, not in the
     kernels' table) at the encoder's shapes (B=48, 600 points, 32
     channels, into each of the three 64x64 planes' cells and the grid's
     32^3): bit-equal to its plain version on a CPU copy, two launches
     bit-equal, its gather backward bit-equal to the CPU's; timed at the
     xz plane and the grid beside the plain version (`scatter_add_`) and
     one `scatter_reduce_` mean call; then the encoder's pooled-max kernels
     (forward and backward, the same file, a row of the kernels' table
     though they replace no TPU kernel) at the same shapes, features with
     ties: forward and backward bit-equal to the plain version's autograd
     on a CPU copy and launch to launch; timed at the xz plane and the grid
     beside the plain version on the card (`scatter_reduce` amax and
     `gather`, an atomic backward) and the same under deterministic
     algorithms, and four pooled maxes and the scatter-mean on one shared
     CSR bit-equal with one build; then the CSR build that these kernels
     read (`csrc/csr.cu`, a row of the kernels' table though it replaces
     no TPU kernel): offsets and rows equal to a stable argsort's at the
     gathers' and the encoder's shapes, under heavy ties, with most
     targets empty, in its device-memory tier (40,000 and 100,000
     targets) and at ragged sizes, timed at DGCNN's kNN indices beside one
     stable `torch.sort`; then the gathers' backward kernel (`csrc/gather.cu`, a
     row of the kernels' table though it replaces no TPU kernel) at the
     victims' training shapes (B=32: DGCNN's four EdgeConv blocks at its
     [32, 1024, 20] kNN indices, C = 3, 64, 64, 128; PointNet++'s level-1
     features [32, 512, 128] at [32, 128, 64] and its xyz at [32, 512,
     32]; a set whose indices fall in 8 points a cloud), int64 and int32
     indices: `index_points`' gradient bit-equal to the plain version's
     autograd on a CPU copy, two launches each (and two CSR builds); timed at DGCNN's second
     and fourth blocks and PointNet++'s features beside the plain version
     (atomic) and the same under deterministic algorithms, and the two
     yardsticks alone (`scatter_add_`, atomic and deterministic);
  3. checks the ConvONet-Opt path on a small input against the port's own
     CPU run (the plain versions) with the same draws, in both modes, at
     256 optimised points and at 6000;
  4. writes a synthetic npz (48 clouds x 1024 points) and seeded weights,
     and runs `if_defense_tpu_torch.cli.opt_defense` at full width for 201
     steps in the reference mode (f32) and the fast mode (bf16, corner
     cache every 16 steps, cached repulsion graph), with every kernel
     launch counter set to 0 just before each run and read just after (B1
     402 and B4 201 + 201 launches in the reference mode, B3 402 in the
     fast mode, B2 exactly 13: once per 16-step window; the scatter-mean
     3 and the pooled max 12 forward and no backward in each), then a second run of each mode, its output bit-equal to
     the first run's (same --seed and file; on a failure the first module
     input or output that differs between two hooked runs is named); then
     profiles a
     reference-mode step of ConvONet-Opt and ONet-Opt
     (`tools/profile_defense_step.py`: 5 and 10 warm steps, differenced:
     wall ms, device ms, busy share, device operations);
  5. holds B5 (FPS) and B6 (ball query) against their plain versions at
     PU-Net's four set-abstraction levels, on the level inputs of one batch
     (128) of phase 7's clouds, unmasked and masked: indices bit-equal;
     times both, and B5 per step (device time over the 1920 steps, the SM
     clock sampled by nvidia-smi beside the window; B6's mean scan length
     and its warps a group of 32 centres); then B5 and B6 at the victims'
     shapes (B=32 of the same clouds normalised to the unit sphere: FPS
     1024 -> 512 -> 128, PointNet++ SA1/SA2 at r 0.2/0.4 and 32/64 slots,
     RS-CNN at r 0.23/0.32 and 48/64 slots), masked and not, bit-equal, B6
     timed for information (not summed into B6's row); then past the sizes the kernels keep in
     registers and shared memory, B5 at N = 16385 and 40000 (B=2, npoint
     512, also from `start_idx`) and B6 at N = 12289 and 40000 (B=2, 512
     centres, 32 slots, several staged chunks), masked and not, bit-equal
     and timed once for information;
  6. checks DUP-Net on a small input (B=2, N=1024, the repository's PU-Net
     weights, the same resampling draws) against the port's CPU run;
  7. writes a synthetic npz (256 clouds x 1024 points) and runs
     `if_defense_tpu_torch.cli.defend_npz` at full width (batch 128, PU-Net
     1024 x 4 with `weights/punet_1024_up4.npz`): DUP-Net alone with the
     B5/B6 launch counters set to 0 just before and read just after (first
     run: exactly 8 each, 4 SA levels a batch of 128), then all three
     defenses, then DUP-Net again (warm run); then
     profiles one batch of DUP-Net with torch.profiler;
  8. holds B4 in its training form (forward + the three planes'
     gradients; also with the gradient to p) against the plain version at
     the training shapes (B=32, Q=2048, three 64x64x32 planes, points that
     the normalisation clamps), f32 and bf16, two launches bit-identical;
     times the training call, its plain version and three `F.grid_sample`
     calls summed, with the gradient to their inputs;
  9. trains a small ConvONet (c_dim 8, 16x16 planes) and a narrow ONet (c_dim
     32, decoder 16) for 3 steps on the card and on the CPU from the same
     perturbed `flax_init_params` and sampler batches, and compares losses
     and step 1's gradients;
 10. writes a synthetic occupancy npz (64 union-of-spheres shapes, 3000
     surface points and 10000 labelled queries each, by
     `tools/build_occupancy_dataset.py --synthetic`) and runs
     `if_defense_tpu_torch.cli.train_implicit` at full width for 50 steps
     at lr 1e-3, ConvONet at the CLI's defaults (batch 32, 600 input points,
     2048 queries, 64x64 planes, c_dim 32) and ONet at c_dim 512, hidden
     512, decoder 256, each twice (first and warm run), with B4's and the
     encoder's launch counters set to 0 just before the ConvONet runs and
     read just after (a step: B4 one forward and one plane-gradient launch,
     the scatter-mean 3, the pooled max 12 forward and 12 backward); each
     variant's two runs' weights bit-equal (the CLI runs under
     deterministic algorithms); then profiles 5 ConvONet steps with
     torch.profiler in each of three settings: deterministic as
     the CLI runs, the same without the NaN fill of new tensors, and
     deterministic algorithms off (`profile_training`);
 11. checks a small ONet-Opt on the card against the port's CPU run, then
     runs `if_defense_tpu_torch.cli.opt_defense --variant onet` on phase 4's
     clouds (48 x 1024) with the ONet weights phase 10 trained, 201 steps in
     the reference mode, with B1's launch counter set to 0 just before and
     read just after (first run), then again (warm run);
 12. the victims (PointNet, PointNet++, DGCNN, PointConv, RS-CNN) at their
     published widths, weights from the port's seeded init with batch-norm
     statistics calibrated on the clouds and perturbed: (a) each on a small
     batch (B=4, N=1024), CUDA against the port's CPU path, unmasked and
     masked, logits within rtol and atol 1e-3 (of the largest magnitude);
     (b) `if_defense_tpu_torch.cli.inference` for each on 64 of phase 7's
     clouds in the unit sphere (40 classes, a target label), batch 32,
     normal mode (B5/B6 launch counters set to 0 just before and read just
     after: PointNet++ and RS-CNN 4 each, PointConv 4 and 0, PointNet
     and DGCNN none) then target mode, clouds/s by the host clock around
     main(); the target run held against the port's CPU path on the same
     npz and checkpoint: every cloud's logits at batch 32 within (a)'s
     tolerance with the card on the CPU's kNN graphs, the card's own graphs
     equal to the CPU's but at near ties, its predictions equal but where
     its graph differs or the CPU's two best classes tie within 2 atol, and
     the CLI's accuracy and target success equal to the CPU's but for the
     clouds whose predictions differ; (c) a profile of one warm PointNet++ and one warm DGCNN batch;
     (d) B1-B3 at k = 9, 16 and 33 (above the register top-k; B = 4 and 48,
     N = 1024, random points and the lattice, f32 and bf16) against their
     plain versions with phase 2's tolerances, and their device times at
     B = 48 beside k = 5's;
 13. the attacks (`if_defense_tpu_torch.attack`, `cli/attack.py`), under
     deterministic algorithms as the CLI runs them: (a) every family for 5
     iterations on PointNet++ and PointNet (B=4, N=1024, weights calibrated
     on 32 clouds) and Drop masked on PointNet++, on the card against the
     port's CPU path with the same weights and draws: each victim's input
     gradients in direction (cosine >= 0.999 a cloud), every output finite
     and shaped, and where no max-pool ties by construction (PointNet's
     families but the two that start at clean points, Drop's mask) >= 99.9
     % of coordinates within 1e-4 and success masks equal but at near ties;
     (b) `cli/attack.py` at batch 32 and 1024 points on seeded PointNet++
     and DGCNN: perturb at 5 x 100 (half the defaults' binary steps, a
     fifth of their 500 iterations; B5/B6 and gather-backward launch
     counters set to 0 just before and read just after, 1,000 each and
     2,500: five gathers a backward), then add,
     add_cluster, add_object (1 x 50), kNN on DGCNN with the ellipsoids'
     normals (50), FGM, I-FGM, MI-FGM, PGD (50), Drop (200 points) and a
     mixed perturb (1 x 50), each checked for its shape and budget and
     for gather-backward launches; a
     --resume run stopped after one of two batches and completed,
     bit-identical to an uninterrupted one; `cli/inference.py` rescoring the
     perturb output (its targeted count equal to the attack's but for near
     ties and failed clouds); clouds/s by the host clock around main(); (c)
     a profile of one warm CW iteration on PointNet++ at batch 32
     (`tools/profile_cw_iteration.py`), with and without deterministic
     algorithms in turns;
 14. victim training (`training.py`, `cli/train.py`, `cli/hybrid_train.py`;
     TF32 off; the CLIs under deterministic algorithms, as they run): (a)
     each victim, and PointNet with the feature transform, 3 train steps
     at B=4, N=1024 on the card and on the port's CPU path from the same
     `flax_init_params(0)` values, batches and dropout masks (drawn on the
     CPU, fed to both through the `draw` seam), DGCNN and PointConv on the
     CPU's kNN graphs (`KnnTap`), each step from the CPU's state: loss
     rtol 1e-4, every gradient in the CPU's direction (cosine >= 0.999 a
     tensor; the biases that feed a batch norm, 0 but for rounding, below
     1e-3 of the largest entry, and a tensor below 1e-4 of it within that),
     the batch statistics within 1e-4 of their scale; (b)
     `cli/train.py` at its defaults (batch 32, 1024 points, lr 1e-3, wd
     1e-4) for 2 epochs with `--eval_every 1` on `tools/synthetic_dataset.py`'s
     hard family (8 classes, 320 train and 80 test clouds) for each
     victim, then PointNet with `--feature_transform`, each twice from one
     seed, `final.npz` and its optimiser sidecar bit-equal, B5/B6 and
     gather-backward launch counters set to 0 just before each run and
     read just after: 20 train steps and 2 x 3 padded eval batches are 26
     forwards, so PointNet++ and RS-CNN 52 and 52, PointConv 52 and 0,
     PointNet and DGCNN none; the gather backward
     TRAIN_BACKWARD_LAUNCHES a train step (20, 60, 60, 20, 0);
     `cli/inference.py` scoring each victim's best checkpoint through
     `registry:synth` at the accuracy the run recorded for it, but for
     near ties (printed); `cli/hybrid_train.py` on PointNet++ with a
     jittered copy as `--def_data` (40 steps and 2 x 6 eval batches: 104
     and 104, gather backward 40), twice from one seed and bit-equal, its
     best.npz the epoch of the highest def_test_acc; a
     PointNet++ run of 1 epoch then `--resume` to epoch 2 (26 and 26 each),
     resumed at step 10 with Adam's moments as saved; steps/s by epoch
     from metrics.jsonl's epoch_time (an epoch's steps and its test pass);
     (c) a profile of one warm PointNet++ and one warm DGCNN train step at
     batch 32 (`tools/profile_train_step.py`, also alone on the card).
     B5 over (b): 572 launches, B6: 468, the gather backward 420;
 15. the mesh restoration (`implicit/generation.py`,
     `cli/remesh_defense.py`, the native isosurface library built with
     g++) with phase 10's trained ConvONet and ONet: (a) B=2 clouds at the
     CLI's widths, resolution0 8 x upsample 4, the card against the port's
     CPU path on one encoder subset: ConvONet's dense lattice within 1e-4
     of the largest logit, ONet's coarse grid within 1e-4 with its active
     voxels and top-k indices (a budget that clips) equal, both int8 grids
     equal but at quantum-boundary entries (counted); (b)
     `cli/remesh_defense.py` at its defaults (batch 32, resolution0 32 x
     upsample 4: a 129^3 lattice, 1024 points, bf16 wire) on phase 12's
     64 clouds, ConvONet then ONet, each twice (first and warm run);
     ConvONet with `--wire int8` and `--wire sparse` on 64 of the clouds,
     bit-identical; `--host_workers 1` against one thread a core on 32,
     bit-identical; ONet with `--sample_mode mesh --save_mesh` on 8; ONet
     on phase 13's perturb output, scored by `cli/inference.py` with the
     PointNet++ checkpoint phase 13 attacked; each run's output [n, 1024,
     3], finite, each cloud's largest radius 1 within 1e-5, fewer fallbacks
     than clouds, clouds/s from the metrics sidecar; (c) `estimate_normals`
     on ConvONet for the vertices of one cloud's mesh, B4's launch counters
     set to 0 just before and read just after (one forward and one
     gradient-to-p launch a chunk of 8192 vertices), the normals in the CPU
     path's direction (every vertex at cosine >= 0.99, >= 99.99 % at >=
     0.999); (d) a profile of one warm batch of each
     variant (`tools/profile_remesh_batch.py`, also alone on the card);
 16. the grid ConvONet (c_dim 32, hidden 32, a 32^3 volume, 3D UNet depth
     3) and the rest of the implicit library, TF32 off: (a) B4's uv form
     (`plane_sample_cuda`) against `bilinear_plane_sample` at B=48,
     Q=1024, 64x64 planes of 32, 128 and 6 channels, forward and both
     gradients, f32 and bf16, two launches bit-identical, and the p form
     at 6 channels; timed at FeatureDecoder's 128 channels beside one
     `F.grid_sample` call; then, small, the card against the CPU path
     (GRID_TOL of each tensor's scale; inputs' gradients at >= 99.9 % of
     their entries): the grid ConvONet's encode, decode and gradient to p
     on 2 clouds, PointConvONet, the five registry decoders in eval and
     train mode (GRID_TRAIN_TOL), `LatentEncoder`, `VoxelDecoder`,
     `FeatureDecoder` at c_dim 6 and 128, with z_dim > 0; (b) the grid
     model's training under deterministic algorithms: step 1 on 2 shapes
     on the CPU and twice on the card (loss rtol 1e-5, the decoder's
     gradients to phase 9's bounds, the encoder's at cosine >=
     ENCODER_COS; the card's two runs' gradients bit-equal), then 100
     steps at phase 10's batch (32 x 2048, 600 input points) on phase 10's
     occupancy npz twice from one seed, the final weights bit-equal, the
     encoder's launch counters set to 0 just before and read just after (a
     step: the pooled max 4 forward and 4 backward, the scatter-mean 1,
     the gather backward 8: the volume's corners in the decoder); (c)
     `convonet_opt_defense` with the trained weights on phase 4's 48 x
     1024 clouds, 201 steps, in the reference mode (B1 402 launches, B4
     none), with `interp_refresh=16` (the same bits) and in bf16; (d)
     `cli/remesh_defense.py`'s `defend_clouds` on 32 clouds (the exact
     coarse + refine path to a 129^3 lattice), twice, a warm batch
     profiled, and `generate_meshes`; (e) PointConvONet at 48 x 600, 1024
     queries with the gradient to p (B5 2, B6 2 launches); (f) B4's uv
     form in `FeatureDecoder` at its defaults and the plane ConvONet's
     `decode` with `p_n` (uv form 4 forward, 1 uv and 1 plane gradient
     launches);
 17. the support layer: (a) reference `.pth` state dicts built from
     seeded trees (`tools/reference_pth.py`) at full width (ConvONet at
     `configs/convonet_3plane_mn40.yaml`, ONet 512 / 512 / 256, PU-Net at
     up 4 from the repository's weights, PointNet, DGCNN, PointNet++ with
     `module.` and PointConv seeded and calibrated), written with
     `torch.save` and converted through `if_defense_tpu_torch.convert`
     from the file (each tree equal to its source, each conversion timed);
     the rest under deterministic algorithms, but for one
     `cli/opt_defense.py` run as the CLI runs, which must be bit-equal to
     the deterministic run: `cli/opt_defense.py` (reference mode) on
     phase 4's 48 x 1024 clouds
     with the converted npz bit-equal to the run with the seeded tree (B1
     402, B4 201 + 201 launches), DUP-Net through `cli/defend_npz.py`
     with the converted PU-Net bit-equal to the repository's weights (B5
     and B6 4 each), `cli/inference.py` per converted victim: the same
     record and bit-equal logits as the seeded checkpoint; (b) the
     ConvONet-Opt CLI with its batch split over [cuda:0, cuda:0] (two
     shards of 24, two threads) against one shard of 48 (phase 3's bound,
     >= 99.9 % of coordinates within 1e-4; bit-equal expected), B1 2 x 402
     launches, and `cli/inference.py`'s eval step split the same way (the
     same predictions); (c) `utils.profiling.PhaseTimer` around (b)'s two
     runs within 5 % of the host clock around them, and `trace` around
     two defense steps writing a trace that names B1's and B4's kernels;
     (d) `utils.config.get_model` on the two shipped configs (read with
     `load_config` where PyYAML imports, else as literal dicts) building
     modules that strict-load (a)'s converted weights;
 18. sharded victim training (`training.make_train_step` and
     `cli/train.py` with each batch split over [cuda:0, cuda:0]: two
     shards, two threads, every train-mode batch norm on the whole batch's
     statistics through `parallel.StatsExchange`), TF32 off: (a) each of
     TRAIN_VICTIMS for 3 steps at B=4, N=1024, split against the card's
     one-shard step from the same `flax_init_params(0)` values, batches
     and dropout masks, each split step from the one-shard run's state:
     loss rtol 1e-4, gradients and batch statistics by phase 14 (a)'s
     bounds (`step_differs`), B5/B6 launches 2 x a forward's a step (each
     shard launches its own); (b) PointNet++ at batch 32 for 5 steps held
     the same way (B5 and B6 2 x 2 a step), two split runs of 5 steps
     under deterministic algorithms bit-equal, and a train step's wall,
     CUDA-event and device ms on one shard and split
     (`tools/profile_train_step.py --devices`); (c) `cli/train.py` on
     PointNet++ for 1 epoch at batch 32 on phase 14's data through the
     `devices=` seam, split against one shard: the same record fields,
     the epoch's train loss within TRAIN_CLI_RTOL (float32 trajectories
     part; see the constant), each run's best checkpoint scored by
     `cli/inference.py` at the accuracy the run recorded but for near
     ties; then the split run again from one seed, its `final.npz` and
     optimiser sidecar bit-equal to the first's; the gather backward
     launched in the phase;
 19. the accuracy protocol's tool, `tools/accuracy_benchmark_torch.py`,
     end to end on cuda:0 at tiny sizes (8 classes x 8 train and 4 test
     clouds of 1024 points, 2 epochs, 20 ConvONet steps; clean, kNN and
     perturb x none, SRS, SOR, DUP-Net and ConvONet-Opt f32 and bf16_r16,
     10 defense iterations), every launch counter set to 0 just before and
     read just after: its results.json with every cell a share of the 32
     clouds, every leg on cuda:0 with TF32 off, and B1, B4, the
     scatter-mean, the pooled max, B5 and B6 launched. The full protocol is a separate
     run of the tool (RESULTS_DISCRIM_TORCH.md);
 20. the port's one optimiser (`optim.OptaxAdam`, optax's Adam in the
     arithmetic of the JAX package's jitted steps) in each of its three
     forms, 12 steps on the card and on a CPU copy from the same start and
     the same gradients (entries over eight decades): the defense's points
     (48 x 1024, lr 1e-3), a CW attack's variables through `attack.cw.adam`
     (32 x 1024, lr 1e-3) and full-width PointNet's weights through
     `training.create_train_state` (L2 decay 1e-4, the cosine schedule
     over 10 steps, so it ends inside the 12); first each elementwise
     operation it runs alone on 2^20 entries: every one the CPU's bits but
     torch's CUDA division of a list by a scalar, which multiplies by the
     scalar's float32 reciprocal (one rounding more than the CPU's IEEE
     division) and must be that product's bits; then each form bit-equal
     (weights, moments and rates) to a CPU copy that divides so
     (`reciprocal_division`), its gap from the plain CPU copy printed as a
     share of the rate times the steps.
The last lines are the rates, the defense step, victim batch, CW
iteration, train step and remesh batch profiles, phase 16's rates, phase
17's, 18's, 19's and 20's numbers, the scatter-mean kernel's line (its
times and launches), the pooled max's times at the grid, the card's name
and power limit, one JSON line of the kernels,
and `{"ok": true, "device": {...}}`.

Each kernel row carries three times, all in f32 at the path's shapes
(B2 also in bf16, the fast mode's type, as the row `repulsion_mask_bf16`):
- `device_ms` (also `ms`): the device time of what the wrapper launches per
  call (its kernels, and any fill or cast it does around them), from
  torch.profiler over 20 calls of the wrapper alone, forward and backward
  (the backward fed the gradient, so no harness loss runs): the self
  device time of the kernels named, summed, over 20. The printed graph
  replay (one call captured in a CUDA graph, CUDA events around 50
  replays) cross-checks it and stands in for it if the profiler ever sees
  no kernel;
- `call_ms`: the median of 20 CUDA-event timings of one whole eager call
  with a harness loss, `(out * w).sum()`, and its backward: what an eager
  step pays, host work included wherever the device waits for it;
- `plain_ms`: the same whole-call timing of the plain version.
B4's rows add `library_device_ms` (also `library_ms`: every kernel of the
three `F.grid_sample` calls' forward and backward and of their sum, the
gradients' fills included), `library_call_ms` and `bound_whole_planes_ms`
(the bound with every plane byte read, as the one-plane design's rows
counted it). The gather backward's row (DGCNN's second block) times the
wrapper alone, fed the output's gradient (`device_ms`: its CSR build
and its sums), the forward and backward with the harness loss
(`call_ms`, `plain_ms`), and one `scatter_add_` into zeros (`library_ms`,
torch's atomic backward), and adds `deterministic_plain_ms` (the plain
version under deterministic algorithms).
`bound_share` is `bound_ms / device_ms`; `launches_per_call` counts the
device operations a call of the wrapper alone launches (profiler).

Each kernel's `bound_ms` is the least time the card could take for its
work on this run's inputs: the larger of its operations over 67 TFLOP/s
(f32, outside the tensor cores) and its bytes (each input read once, each
output written once) over 3.35 TB/s, the H100 SXM's published peaks.
Operations counted: 8 flops for a pair's squared distance (3 sub, 3 mul,
2 add) and 1 for its selection compare; 50 for a weighted repulsion pair's
term and gradient; per query, plane and channel 10 for B4's forward (a
bilinear sample and the sum over the planes), 12 for its gradient to p
and 10 for its share of the planes' gradients (6 multiplies, 4 adds),
whose bytes are p, the output's gradient and the output read or written
once, dp written once, every cell of the three planes' gradients written
once, and of the planes the distinct corner rows ([C] channels of a cell)
that this run's queries touch, read once; FPS 10 per point
and step (distance, min, compare); ball query 9 per (centre, point) pair
scanned up to the centre's nsample-th hit and 5 per |v|^2; the pooled
max 4 per point and channel (the max's compare, the tie's, the
gradient's add and its share), whose bytes are the features, the output's
gradient and the int64 cells read once, the output and the gradient
written once; the gather backward 1 add per row and channel, whose bytes
are the output's gradient and the indices read once and the gradient
written once.

f32 phases run with TF32 off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# cuBLAS's deterministic workspace, which the attack CLI's deterministic
# algorithms need: it takes effect only where set before the process's
# first cuBLAS handle, and phases 2-12 create one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

B, N, R, C = 48, 1024, 64, 32
SCATTER_N = 600                          # the encoder's input points
LR, SMALL_ITERS = 1e-3, 5
DUP_B, DUP_CLOUDS = 128, 256             # defend_npz's batch; clouds in its file
SA_LEVELS = ((1024, 0.05), (512, 0.1), (256, 0.2), (128, 0.3))
# the victims' ball queries at cli/inference.py's batch: (centres, radius,
# nsample) of set-abstraction levels 1 and 2 (models/pointnet2.py:153,156,
# models/rscnn.py:95,98); level 2 groups level 1's centres
VICTIM_B = 32
VICTIM_LEVELS = (("PointNet++", ((512, 0.2, 32), (128, 0.4, 64))),
                 ("RS-CNN", ((512, 0.23, 48), (128, 0.32, 64))))
VICTIMS = ("pointnet", "pointnet2", "dgcnn", "pointconv", "rscnn")
VICTIM_CLOUDS, VICTIM_TOL = 64, 1e-3
KNN_TIE = 1e-5        # a near tie of kNN, of |q|^2 + max |x|^2 in the row
# B5 and B6 launches of one VICTIM_CLOUDS pass at batch 32: two sampled
# levels a batch (models/pointnet2.py, pointconv.py, rscnn.py; PointConv
# groups by kNN, PointNet and DGCNN sample nothing)
VICTIM_LAUNCHES = {name: (fps * VICTIM_CLOUDS // VICTIM_B,
                          bq * VICTIM_CLOUDS // VICTIM_B)
                   for name, (fps, bq) in {
                       "pointnet": (0, 0), "pointnet2": (2, 2),
                       "dgcnn": (0, 0), "pointconv": (2, 0),
                       "rscnn": (2, 2)}.items()}
MESH_SAVE_CLOUDS = 8          # ONet-Mesh with --sample_mode mesh (phase 15)
REPULSION_KS = (9, 16, 33)               # above the register top-k's 8
# phase 13: (a) small attacks, B clouds of 1024 points, a few iterations,
# held to phase 3's bound (a share of coordinates within ATTACK_TOL);
# (b) cli/attack.py at its batch of 32, beside perturb at its defaults:
# (attack, victim, flags) at reduced iterations, widths and batch as
# published
ATTACK_SMALL_B, ATTACK_SMALL_ITERS = 4, 5
ATTACK_TOL, ATTACK_SHARE, GRAD_COS = 1e-4, 0.999, 0.999
# the (victim, family) runs of (a) held to the bound: no max-pool of the
# victim ties by construction (see check_small_attacks)
ATTACK_BOUND = {("pointnet", f) for f in (
    "perturb", "add_object", "knn", "fgm", "ifgm", "mifgm", "pgd")} | {
    ("pointnet2", "drop (masked)")}
ATTACK_B = 32
PERTURB_DEPTH = (5, 100)       # binary steps x iterations (the CLI's 10 x 500)
ATTACK_RUNS = (
    ("add", "pointnet2", ["--binary_step", "1", "--num_iter", "50"]),
    ("add_cluster", "pointnet2", ["--binary_step", "1", "--num_iter", "50"]),
    ("add_object", "pointnet2", ["--binary_step", "1", "--num_iter", "50"]),
    ("knn", "dgcnn", ["--num_iter", "50"]),
    ("fgm", "pointnet2", []),
    ("ifgm", "pointnet2", []),
    ("mifgm", "pointnet2", []),
    ("pgd", "pointnet2", []),
    ("drop", "pointnet2", []),
    ("perturb", "pointnet2", ["--binary_step", "1", "--num_iter", "50",
                              "--victim_dtype", "mixed"]),
)
# points a cloud of each attack's output (K = 1024): Add appends 512,
# Add-Cluster 3 x 32, Add-Object 3 x 64; Drop removes 200
ATTACK_POINTS = {"add": 1536, "add_cluster": 1120, "add_object": 1216,
                 "drop": 824}
NEAR_FACTOR = 1.5
PEAK_F32, HBM = 67e12, 3.35e12           # FLOP/s, bytes/s (H100 SXM)
TB, TQ = 32, 2048                        # train_implicit's batch and queries
TRAIN_STEPS, TRAIN_LR = 50, 1e-3
DEVICE_REPS, GRAPH_REPS = 20, 50          # calls per device-time reading
PLANE_NAMES = ("xz", "xy", "yz")
# phase 14: victim training. (a) small steps, CUDA vs CPU; (b) the train
# CLIs at their defaults (batch 32, 1024 points) on 8 classes x (40 train,
# 10 test) clouds; B5/B6 launches of one forward (two sampled levels;
# PointConv groups by kNN, PointNet and DGCNN sample nothing)
TRAIN_VICTIMS = (("pointnet", {}), ("pointnet", {"feature_transform": True}),
                 ("pointnet2", {}), ("dgcnn", {}), ("pointconv", {}),
                 ("rscnn", {}))
TRAIN_SMALL_B, TRAIN_SMALL_STEPS = 4, 3
TRAIN_LOSS_RTOL, TRAIN_STATS_TOL = 1e-4, 1e-4
TRAIN_B, TRAIN_EPOCHS, TRAIN_PER_CLASS = 32, 2, (40, 10)
TRAIN_FORWARD_LAUNCHES = {"pointnet": (0, 0), "pointnet2": (2, 2),
                          "dgcnn": (0, 0), "pointconv": (2, 0),
                          "rscnn": (2, 2)}
# gather-backward launches of one train step: the gathers whose points
# need a gradient (the input cloud does not): PointNet++'s and RS-CNN's
# level-2 features, DGCNN's blocks 2-4, PointConv's level-1 density
# scales and level-2 features and density scales
TRAIN_BACKWARD_LAUNCHES = {"pointnet": 0, "pointnet2": 1, "dgcnn": 3,
                           "pointconv": 3, "rscnn": 1}
# phase 18: sharded victim training, each batch split over [cuda:0,
# cuda:0]; (b) PointNet++ at TRAIN_B for SPLIT_FULL_STEPS steps; (c) the
# train CLI's epoch loss, split against one shard: their trajectories part
# (float32 rounding differs with the split, and Adam turns a gradient near
# rounding level into a step of the rate of either sign: at 128 points and
# batch 4 on the CPU two such runs of PointNet++ part by 1e-3 after two
# steps, 3.6e-2 after six), so the steps are held one by one in (a) and
# (b), and the CLI's epoch mean loosely
SPLIT_FULL_STEPS, TRAIN_CLI_RTOL = 5, 5e-2
# phase 15: the mesh restoration. (a) small runs CUDA vs CPU at B clouds,
# resolution0 x upsample, logits within MESH_TOL of the largest; (b)
# cli/remesh_defense.py at its defaults (batch 32, a 129^3 lattice)
MESH_B, MESH_SMALL_B, MESH_R0, MESH_U, MESH_TOL = 32, 2, 8, 4, 1e-4
# phase 16: the grid ConvONet and the rest of the implicit library; small
# runs on the card against the CPU path within GRID_TOL of the largest
# magnitude (f32, TF32 off; the 3D UNet's convolutions sum in other orders)
GRID_TOL = 1e-4
GRID_TRAIN_TOL = 1e-3         # the registry decoders in train mode
ENCODER_COS = 1 - 1e-5        # grid training's step 1, the encoder's gradients
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class SmClock:
    """The SM clock in MHz, sampled every 100 ms by `nvidia-smi` while the
    block runs (the process is stopped on exit); `readings` holds them."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.3)
        return self

    def __exit__(self, *exc):
        time.sleep(0.3)
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.readings = [int(v) for v in out.split() if v.isdigit()]
        return False

    def text(self) -> str:
        r = self.readings
        return (f"SM clock {min(r)}-{max(r)} MHz over {len(r)} readings"
                if r else "SM clock not read")


def median_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of one whole call of `fn`: what
    an eager step pays per call, host work (autograd, allocation, binding)
    included wherever the device waits for it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _label(key: str, names) -> str | None:
    """The name in `names` that a profiler kernel name is (a function name
    followed by its template arguments or parameters), else None; with
    `names` None, the kernel's own function name."""
    if names is None:
        key = key.replace("(anonymous namespace)::", "")
        found = re.search(r"(\w+)\s*[<(]", key.removeprefix("void "))
        return found.group(1) if found else key[:40]
    return next((n for n in names if re.search(rf"\b{re.escape(n)}[<(]", key)),
                None)


def device_ms(fn, names=None, reps: int = DEVICE_REPS):
    """Device time of what `fn` launches per call: torch.profiler over
    `reps` calls, for each kernel named in `names` (every kernel if None)
    its self device time per launch times its launches per call, summed
    (the profiler has been seen to drop a kernel's first launch of the
    window, so a total over `reps` would undercount). -> (ms,
    {kernel: its ms per call}, {kernel seen but not counted: launches},
    device operations launched per call, every kind counted), or None
    where the profiler saw no kernel of `names`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    total, ours, others, ops = 0.0, {}, {}, 0
    for e in stats:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0 or e.key in host):
            continue
        ops += max(1, round(e.count / reps))
        label = _label(e.key, names)
        if label is None:
            label = _label(e.key, None)
            others[label] = others.get(label, 0) + e.count
            continue
        ms = e.self_device_time_total / 1e3 / e.count * max(
            1, round(e.count / reps))
        total += ms
        ours[label] = ours.get(label, 0.0) + ms
    if not ours:
        return None
    return total, ours, others, ops


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Device time per call of `fn` with no host work between kernels: one
    call captured in a CUDA graph (its buffers allocated at capture), then
    CUDA events around `reps` back-to-back replays, over `reps`. Includes
    the gaps between the graph's kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof) -> list:
    """A profile's device operations with device time: a user annotation's
    device-side range (Adam's step) spans kernels that are counted on their
    own, and it also has a host-side event of its name, which no kernel
    has."""
    stats = prof.key_averages()
    host = {e.key for e in stats
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in stats
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in host]


def print_top(events, n: int) -> None:
    """The n device operations that take the most time."""
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:n]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}")


def kernel_times(call, plain, bare, names, library=None) -> dict:
    """The timings of one kernel row. `call` and `plain` are the harness
    calls (forward, harness loss, backward) of the wrapper and of the plain
    version, timed whole (`call_ms`, `plain_ms`). `bare` runs only the
    wrapper (its backward fed the gradient, no harness loss); the kernels
    it launches, `names`, are read by the profiler (`device_ms`) and, as a
    cross-check, by graph replay (`graph_ms`). The fallback where the
    profiler sees no kernel is the graph replay, never the whole call.
    `library` = (harness call, bare call) of the one PyTorch call computing
    the same function: `library_call_ms`, and `library_device_ms` over
    every kernel its bare call launches."""
    got = device_ms(bare, names)
    graph = graph_ms(bare)
    if got is None:
        print(f"  the profiler saw no kernel of {names}: device_ms from "
              "graph replay")
        got = (graph, {}, {}, None)
    dev_ms, ours, others, ops = got
    row = dict(call_ms=median_ms(call), plain_ms=median_ms(plain),
               device_ms=dev_ms, graph_ms=graph, launches_per_call=ops,
               library_call_ms=None, library_device_ms=None)
    split = ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
    print(f"  device {dev_ms:.4f} ms per call (profiler, {DEVICE_REPS} calls:"
          f" {split}{f'; not counted: {others}' if others else ''}; "
          f"{ops} device operations a call), graph replay {graph:.4f} ms, "
          f"whole call {row['call_ms']:.4f} ms")
    if library is not None:
        lib = device_ms(library[1])
        row["library_call_ms"] = median_ms(library[0])
        row["library_device_ms"] = (lib[0] if lib is not None
                                    else graph_ms(library[1]))
        split = (", ".join(f"{k} {v:.4f}" for k, v in lib[1].items())
                 if lib else "graph replay")
        print(f"  library device {row['library_device_ms']:.4f} ms "
              f"({split}), whole call {row['library_call_ms']:.4f} ms")
    return row


def bare_grad(fn, x: torch.Tensor, g: torch.Tensor, *args):
    """fn(x, *args) and its backward to x alone, fed the gradient `g`: only
    what the wrapper launches (no harness loss and no backward of it)."""
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(x, *args), x, g)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for f32 work."""
    ops_ms, bytes_ms = flops / PEAK_F32 * 1e3, nbytes / HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ellipsoids(gen, n: int) -> np.ndarray:
    """n clouds of 1024 points on ellipsoid surfaces, 8 outliers each (SOR
    has work to do), f32."""
    return ellipsoids_and_normals(gen, n)[0]


def ellipsoids_and_normals(gen, n: int) -> tuple[np.ndarray, np.ndarray]:
    """`ellipsoids`' clouds (the same draws) and their surfaces' unit
    normals, the gradient of x^2/a^2 + y^2/b^2 + z^2/c^2 (the outliers get
    their directions' normals)."""
    d = gen.normal(size=(n, 1024, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = gen.uniform(0.3, 1.0, (n, 1, 3))
    pc = d * axes
    pc[:, :8] *= 3.0
    normal = d / axes
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return pc.astype(np.float32), normal.astype(np.float32)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float,
            rtol: float) -> float:
    """max |got - ref|; fails unless |got - ref| <= atol + rtol |ref|."""
    got, ref = got.detach().float(), ref.detach().float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
             "or non-finite values")
    err = (got - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    worst = float(err.max())
    print(f"  {name}: max_abs_err {worst:.3e} (atol {atol:g}, rtol {rtol:g})"
          f"{'' if not bad else f', {bad} out of tolerance'}")
    if bad:
        fail(f"{name} disagrees with its plain version")
    return worst


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (signed zeros and NaNs
    told apart), wherever they lie."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def grad_atol(ref: torch.Tensor) -> float:
    """Absolute tolerance of a gradient: 1e-5 of its largest entry. The
    kernel and the plain version sum a point's pair terms in other orders,
    and an entry near 0 is a cancellation of terms of the larger size."""
    return 1e-5 * float(ref.detach().float().abs().max())


def value_and_grad(fn, x: torch.Tensor, w: torch.Tensor):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out.float() * w).sum(), x)
    return out.detach(), g


def lattice(gen, b: int, shape: tuple[int, int, int]) -> np.ndarray:
    """b clouds of the nodes of a shape[0] x shape[1] x shape[2] grid at
    spacing 1/16, each in its own random order: every squared distance is
    exact in f32 (and bf16), so ties at a row's k-th smallest are real."""
    axes = [np.arange(s) - s // 2 for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3) / 16
    return np.stack([grid[gen.permutation(len(grid))]
                     for _ in range(b)]).astype(np.float32)


def check_repulsion(what: str, pts, moved, w,
                    k: int = 5) -> tuple[list, list, torch.Tensor]:
    """B1, B2 and B3 against their plain versions on one input, f32 and
    bf16, at k neighbours: losses rtol 1e-5, gradients atol 1e-5 of the
    largest entry and rtol 1e-4 (f32) or 2^-7 (bf16), masks bit-equal. B3
    takes the f32 mask of `pts` at the points `moved`. -> (B1 f32 errors,
    B3 f32 errors, the f32 mask)."""
    from if_defense_tpu_torch.defense import repulsion as rep
    from if_defense_tpu_torch.ops import cuda_repulsion

    tols = ((torch.float32, 1e-4), (torch.bfloat16, 2.0**-7))
    errs = {"B1": [], "B3": []}
    masks = {}
    for dt, _ in tols:
        mk = cuda_repulsion.repulsion_mask_cuda(pts.to(dt), k)
        diff = int((mk != rep.repulsion_mask(pts.to(dt), k)).sum())
        print(f"  {what} B2 mask {str(dt).split('.')[-1]}: {diff} entries "
              f"differ (bit-equal required), {int(mk.sum())} ones")
        if diff:
            fail(f"B2 mask disagrees with its plain version ({what})")
        masks[dt] = mk
    mask = masks[torch.float32]
    pairs = {"B1": (lambda x: cuda_repulsion.repulsion_loss_cuda(x, k),
                    lambda x: rep.repulsion_loss_threshold(x, k), pts),
             "B3": (lambda x: cuda_repulsion.repulsion_loss_masked_cuda(
                        x, mask, k),
                    lambda x: rep.repulsion_loss_masked(x, mask, k), moved)}
    for kid, (kern, plain, x) in pairs.items():
        for dt, gr in tols:
            lk, gk = value_and_grad(kern, x.to(dt), w)
            lp, gp = value_and_grad(plain, x.to(dt), w)
            tag = f"{what} {kid} {str(dt).split('.')[-1]}"
            e = [compare(f"{tag} loss", lk, lp, 1e-9, 1e-5),
                 compare(f"{tag} grad", gk, gp, grad_atol(gp), gr)]
            if dt == torch.float32:
                errs[kid] += e
    return errs["B1"], errs["B3"], mask


def check_kernels(dev) -> list[dict]:
    from if_defense_tpu_torch.defense import repulsion as rep
    from if_defense_tpu_torch.ops import cuda_repulsion

    gen = np.random.default_rng(0)
    pts = gen.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    pts[:, N - 24:] = pts[:, :24]          # exact duplicates, as resampling makes
    pts = torch.from_numpy(pts).to(dev)
    w = torch.from_numpy(gen.uniform(0.5, 1.5, B).astype(np.float32)).to(dev)
    rows = []

    print("B1-B3 on random points with duplicates (B3's mask built from the "
          "points, then held while they move by ~1e-3):")
    moved = pts + 1e-3 * torch.randn(pts.shape, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    b1_errs, b3_errs, mask = check_repulsion("random", pts, moved, w)
    print(f"B1-B3 on a 16x8x8 lattice at spacing 1/16 (ties at every "
          f"threshold), {B} clouds in random orders:")
    lat = torch.from_numpy(lattice(gen, B, (16, 8, 8))).to(dev)
    e1, e3, _ = check_repulsion("lattice", lat, lat, w)
    b1_errs += e1
    b3_errs += e3

    pts_bytes = 4 * B * N * 3
    print("B1 repulsion_loss (fwd + bwd), random points, f32:")
    rows.append(dict(
        name="repulsion_loss", id="B1",
        source="if_defense_tpu_torch/csrc/repulsion.cu",
        replaces="if_defense_tpu/ops/pallas_repulsion.py:196",
        max_abs_err=max(b1_errs),
        bound=bound(9 * B * N * N + 50 * B * N * 5, 2 * pts_bytes + 8 * B),
        **kernel_times(
            lambda: value_and_grad(cuda_repulsion.repulsion_loss_cuda, pts, w),
            lambda: value_and_grad(rep.repulsion_loss_threshold, pts, w),
            lambda: bare_grad(cuda_repulsion.repulsion_loss_cuda, pts, w),
            ("rep_fwd", "rows_to_loss", "rep_bwd"))))

    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        x = pts.to(dt)
        print(f"B2 repulsion_mask, random points, {str(dt).split('.')[-1]}:")
        rows.append(dict(
            name="repulsion_mask" + suffix, id="B2",
            source="if_defense_tpu_torch/csrc/repulsion.cu",
            replaces="if_defense_tpu/ops/pallas_repulsion.py:267",
            max_abs_err=0.0,
            bound=bound(9 * B * N * N, x.element_size() * B * N * 3 + B * N * N),
            **kernel_times(
                lambda: cuda_repulsion.repulsion_mask_cuda(x),
                lambda: rep.repulsion_mask(x),
                lambda: cuda_repulsion.repulsion_mask_cuda(x), ("rep_mask",))))

    print("B3 repulsion_loss_masked (fwd + bwd), moved points, f32:")

    def masked(x):
        return cuda_repulsion.repulsion_loss_masked_cuda(x, mask)

    rows.append(dict(
        name="repulsion_loss_masked", id="B3",
        source="if_defense_tpu_torch/csrc/repulsion.cu",
        replaces="if_defense_tpu/ops/pallas_repulsion.py:390",
        max_abs_err=max(b3_errs),
        bound=bound(50 * float(mask.sum()),
                    2 * pts_bytes + 8 * B + B * N * N),
        **kernel_times(
            lambda: value_and_grad(masked, moved, w),
            lambda: value_and_grad(
                lambda x: rep.repulsion_loss_masked(x, mask), moved, w),
            lambda: bare_grad(masked, moved, w),
            ("rep_masked_fwd", "rows_to_loss", "rep_masked_bwd"))))

    print(f"B4 plane_features, the defense form (fwd + gradient to p), "
          f"three {R}x{R}x{C} planes:")
    rows.append(check_plane_features(dev, gen, B, N, train=False))
    for r in rows:
        print_row(r)
    return rows


def check_scatter(dev) -> dict:
    """Phase 2's encoder scatter-mean kernel (`csrc/scatter.cu`; it replaces
    no TPU kernel, so its line stands apart from the kernels' table) at the
    encoder's shapes: B=48 clouds of SCATTER_N points normalised as the
    defense does, C=32 channels, into each of the three 64x64 planes' cells
    and the grid's 32^3 cells. Bit-equal to the plain version on a CPU copy
    (means and each point's count) and from one launch to the next; the
    gather backward bit-equal to the CPU's. Timed at the xz plane and the
    grid: the wrapper's device time (sort, fill, kernel) over 20 calls by
    the profiler, its whole call, the plain version on the card
    (`scatter_add_`, atomics) and one `scatter_reduce_(..., "mean")` call;
    the bound counts the features and indices read once and the cells and
    counts written once. -> the printed numbers."""
    from if_defense_tpu_torch.implicit.convonet import (
        coordinate2index,
        coordinate2index_3d,
        normalize_3d_coordinate,
    )
    from if_defense_tpu_torch.ops import cuda_scatter, normalize_coordinate
    from if_defense_tpu_torch.ops.normalize import normalize_unit_cube
    from if_defense_tpu_torch.ops.scatter import (
        scatter_mean_2d,
        scatter_mean_2d_plain,
    )

    gen = np.random.default_rng(19)
    pc = normalize_unit_cube(torch.from_numpy(
        ellipsoids(gen, B)[:, :SCATTER_N]), 0.9)
    feat = torch.from_numpy(
        gen.normal(size=(B, SCATTER_N, C)).astype(np.float32))
    cells = {pl: (coordinate2index(normalize_coordinate(pc, pl, 0.1), R),
                  R * R) for pl in PLANE_NAMES}
    cells["grid 32^3"] = (coordinate2index_3d(normalize_3d_coordinate(pc),
                                              32), 32**3)
    fd = feat.to(dev)
    g_out = {}
    before = cuda_scatter.launches["scatter_mean"]
    for name, (idx, k) in cells.items():
        want, counts = scatter_mean_2d_plain(feat, idx, k)
        idd = idx.to(dev)
        got = [cuda_scatter.scatter_mean_cuda(fd, idd, k) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(m.cpu(), want) and torch.equal(
            n.cpu(), torch.gather(counts, 1, idx.long())) for m, n in got)
        repeat = torch.equal(got[0][0], got[1][0])
        g = torch.randn((B, k, C), generator=torch.Generator().manual_seed(k))
        grads = []
        for d in ("cpu", dev):
            x = feat.detach().to(d).requires_grad_(True)
            scatter_mean_2d(x, idx.to(d), k).backward(g.to(d))
            grads.append(x.grad.cpu())
        occupied = int((counts > 0).sum(1).max())
        print(f"  scatter-mean {name}: {k} cells, up to {occupied} occupied "
              f"a cloud, up to {int(counts.max())} points a cell; bit-equal "
              f"to the plain version on a CPU copy {same}, two launches "
              f"{repeat}, backward {torch.equal(grads[0], grads[1])}")
        if not (same and repeat and torch.equal(grads[0], grads[1])):
            fail(f"the scatter-mean kernel ({name}) is not bit-equal to its "
                 "plain version on a CPU copy, or from launch to launch")
        g_out[name] = (idd, k)
    out = {"launches_check": cuda_scatter.launches["scatter_mean"] - before}
    for name in ("xz", "grid 32^3"):
        idd, k = g_out[name]
        ixp = idd.long()[..., None].expand(-1, -1, C)
        got = device_ms(lambda: cuda_scatter.scatter_mean_cuda(fd, idd, k))
        call = median_ms(lambda: cuda_scatter.scatter_mean_cuda(fd, idd, k))
        plain = median_ms(lambda: scatter_mean_2d_plain(fd, idd, k))
        library = device_ms(lambda: torch.zeros(B, k, C, device=dev)
                            .scatter_reduce_(1, ixp, fd, "mean",
                                             include_self=False))
        bnd = bound(B * SCATTER_N * C + B * k * C,
                    4 * B * SCATTER_N * C + 8 * B * SCATTER_N
                    + 4 * B * k * C + 4 * B * SCATTER_N)
        row = {"device_ms": got[0], "call_ms": call, "plain_ms": plain,
               "library_ms": library[0], "bound_ms": bnd[0],
               "bound_by": bnd[1], "kernels": got[1]}
        out[name] = row
        print(f"  scatter-mean {name}: device {got[0]:.4f} ms "
              f"({', '.join(f'{n} {v:.4f}' for n, v in got[1].items())}), "
              f"whole call {call:.4f} ms, plain (scatter_add_) {plain:.4f} "
              f"ms, scatter_reduce mean device {library[0]:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")
    return out


def check_pooled_max(dev) -> dict:
    """Phase 2's pooled-max kernels (`csrc/scatter.cu`, forward and
    backward; no TPU kernel) at the encoder's shapes: B=48 clouds of
    SCATTER_N points normalised as the defense does, C=32 channels, each
    point given its cell's max among the three 64x64 planes' cells and the
    grid's 32^3. Every third point is a copy of the one before it, place
    and features, so cells hold ties; most cells are empty. Forward and
    backward bit-equal (every bit, signed zeros included) to the plain
    version's autograd on a CPU copy, and from one launch to the next.
    On one CSR built for the index (`cell_csr`, as the encoder shares it),
    four pooled maxes give the same bits, their backward too, and the
    scatter-mean its plain version's, with one CSR build for all. Timed at
    the xz plane and the grid, forward and backward fed the gradient: the
    wrapper's device time (the CSR build and both kernels) by the
    profiler over 20 calls with its device operations a call, its whole
    call with a harness loss, the plain version
    on the card (`scatter_reduce` amax and `gather`, whose backward adds
    with atomics) and the same under deterministic algorithms (torch's
    sort-based backward); the bound counts the features, indices and the
    output's gradient read once and the output and the gradient written
    once. -> the xz plane's row of the kernels' line, with the grid's
    numbers and the deterministic path's beside it."""
    from if_defense_tpu_torch.implicit.convonet import (
        coordinate2index,
        coordinate2index_3d,
        normalize_3d_coordinate,
    )
    from if_defense_tpu_torch.ops import cuda_csr, normalize_coordinate
    from if_defense_tpu_torch.ops.normalize import normalize_unit_cube
    from if_defense_tpu_torch.ops.scatter import (
        cell_csr,
        pooled_max_by_cell,
        pooled_max_by_cell_plain,
        scatter_mean_2d,
        scatter_mean_2d_plain,
    )
    from if_defense_tpu_torch.utils.determinism import deterministic

    gen = np.random.default_rng(21)
    pc = ellipsoids(gen, B)[:, :SCATTER_N]
    feat = gen.normal(size=(B, SCATTER_N, C)).astype(np.float32)
    # every third point a copy of the point before it, place and features
    # (a cloud sampled with replacement): maxima tie
    third = SCATTER_N // 3
    pc[:, 1::3] = pc[:, 0::3][:, :third]
    feat[:, 1::3] = feat[:, 0::3][:, :third]
    pc = normalize_unit_cube(torch.from_numpy(pc), 0.9)
    feat = torch.from_numpy(feat)
    g = torch.from_numpy(gen.normal(size=(B, SCATTER_N, C)).astype(np.float32))
    cells = {pl: (coordinate2index(normalize_coordinate(pc, pl, 0.1), R),
                  R * R) for pl in PLANE_NAMES}
    cells["grid 32^3"] = (coordinate2index_3d(normalize_3d_coordinate(pc),
                                              32), 32**3)
    fd, gd = feat.to(dev), g.to(dev)

    err, rows = 0.0, {}
    for name, (idx, k) in cells.items():
        x = feat.clone().requires_grad_(True)
        want = pooled_max_by_cell_plain(x, idx, k)
        want.backward(g)
        want = want.detach()
        ixp = idx.long()[..., None].expand(-1, -1, C)
        ties = torch.zeros(B, k, C).scatter_add_(1, ixp, (feat == want)
                                                 .float())
        occupied = torch.zeros(B, k).scatter_add_(
            1, idx.long(), torch.ones(B, SCATTER_N))
        got = []
        built = cuda_csr.launches["csr"]
        for _ in range(2):
            xd = fd.clone().requires_grad_(True)
            out = pooled_max_by_cell(xd, idx.to(dev), k)
            out.backward(gd)
            got.append((out.detach(), xd.grad))
        # the encoder's way: one CSR for the index, which four pooled
        # maxes (each way) and the scatter-mean share
        shared = cell_csr(idx.to(dev), k)
        xd = fd.clone().requires_grad_(True)
        outs = [pooled_max_by_cell(xd, idx.to(dev), k, csr=shared)
                for _ in range(4)]
        sum(outs).backward(gd)
        mean = scatter_mean_2d(fd, idx.to(dev), k, shared)
        torch.cuda.synchronize()
        built = cuda_csr.launches["csr"] - built
        shared_same = (all(same_bits(o, got[0][0]) for o in outs)
                       and torch.equal(mean.cpu(),
                                       scatter_mean_2d_plain(feat, idx, k)[0]))
        same = all(same_bits(o, want) and same_bits(gr, x.grad)
                   for o, gr in got) and shared_same and built == 3
        repeat = (same_bits(got[0][0], got[1][0])
                  and same_bits(got[0][1], got[1][1]))
        err = max(err, float((got[0][0].cpu() - want).abs().max()),
                  float((got[0][1].cpu() - x.grad).abs().max()))
        tied = int((ties > 1).sum())
        print(f"  pooled max {name}: {k} cells, up to "
              f"{int((occupied > 0).sum(1).max())} occupied a cloud, up to "
              f"{int(occupied.max())} points a cell, {tied} (cell, channel) "
              f"maxima tied; forward and backward bit-equal to the plain "
              f"version on a CPU copy {same}, two launches {repeat}; on "
              f"one shared CSR, four pooled maxes and the scatter-mean "
              f"bit-equal {shared_same}, {built} CSR builds (want 3)")
        if not tied:
            fail(f"the pooled max's inputs ({name}) hold no ties")
        if not (same and repeat):
            fail(f"the pooled-max kernels ({name}) are not bit-equal to "
                 "their plain version on a CPU copy, or from launch to launch")
        rows[name] = (idx.to(dev), k)

    def harness(fn, idd, k):
        def call():
            x = fd.detach().requires_grad_(True)
            return torch.autograd.grad((fn(x, idd, k) * gd).sum(), x)
        return call

    def deterministic_plain(idd, k):
        call = harness(pooled_max_by_cell_plain, idd, k)

        def run():
            with deterministic():
                return call()
        return run

    nbytes = 4 * 4 * B * SCATTER_N * C + 8 * B * SCATTER_N
    bnd = bound(4 * B * SCATTER_N * C, nbytes)
    out = {}
    for name in ("xz", "grid 32^3"):
        idd, k = rows[name]
        print(f"  pooled max {name}, forward + backward:")
        times = kernel_times(
            harness(pooled_max_by_cell, idd, k),
            harness(pooled_max_by_cell_plain, idd, k),
            lambda: bare_grad(pooled_max_by_cell, fd, gd, idd, k), None)
        times["deterministic_plain_ms"] = median_ms(deterministic_plain(idd, k))
        print(f"  plain (atomic backward) {times['plain_ms']:.4f} ms, "
              f"plain under deterministic algorithms "
              f"{times['deterministic_plain_ms']:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")
        out[name] = times
    row = dict(name="pooled_max", id="scatter.cu",
               source="if_defense_tpu_torch/csrc/scatter.cu",
               replaces="none: if_defense_tpu/ops/scatter.py:41 "
                        "pooled_max_by_cell is XLA, not a Pallas kernel",
               max_abs_err=err, bound=bnd, **out["xz"],
               grid={k: v for k, v in out["grid 32^3"].items()})
    print_row(row)
    return row


def gather_sets(dev) -> dict:
    """Phase 2's gather-backward inputs at the train CLI's batch (B =
    TRAIN_B clouds of 1024 points, phase 7's ellipsoids in the unit
    sphere): {name: (points [B, N, C] f32 on the card, idx [B, ...] on the
    card)}. DGCNN's four EdgeConv blocks gather [B, 1024, C] at its [B,
    1024, 20] kNN indices (int64; C = 3, 64, 64, 128); PointNet++ gathers
    its level-1 features [B, 512, 128] at level 2's [B, 128, 64] ball-query
    indices and the input xyz at level 1's [B, 512, 32] (int32); the tie
    set reads, in each cloud, only 8 of 1024 points at DGCNN's shape."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample,
        index_points,
        knn_points,
        query_ball_point,
    )

    pc = victim_clouds(np.random.default_rng(23), TRAIN_B).to(dev)
    gen = torch.Generator(device=dev).manual_seed(23)

    def feats(n: int, c: int) -> torch.Tensor:
        return torch.randn((TRAIN_B, n, c), generator=gen, device=dev)

    knn = knn_points(20, pc)
    l1 = index_points(pc, farthest_point_sample(pc, 512))
    xyz_idx = query_ball_point(0.2, 32, pc, l1)
    l2 = index_points(l1, farthest_point_sample(l1, 128))
    feat_idx = query_ball_point(0.4, 64, l1, l2)
    eight = torch.stack([torch.randperm(1024, generator=gen, device=dev)[:8]
                         for _ in range(TRAIN_B)])
    ties = torch.gather(eight, 1, torch.randint(
        0, 8, (TRAIN_B, 1024 * 20), generator=gen, device=dev)).reshape(
        TRAIN_B, 1024, 20)
    return {"dgcnn block 1 (C 3)": (pc, knn),
            "dgcnn block 2 (C 64)": (feats(1024, 64), knn),
            "dgcnn block 3 (C 64)": (feats(1024, 64), knn),
            "dgcnn block 4 (C 128)": (feats(1024, 128), knn),
            "pointnet2 level-1 features (C 128)": (feats(512, 128), feat_idx),
            "pointnet2 xyz (C 3)": (pc, xyz_idx),
            "ties, 8 points a cloud (C 64)": (feats(1024, 64), ties)}


def check_csr(dev) -> dict:
    """Phase 2's CSR build (`csrc/csr.cu`; no TPU kernel), which the gather
    backward and the encoder's kernels read: each cloud's rows grouped by
    target, in row order. Bit-equal (offsets and rows) to its plain
    version (`csr_plain`: numpy-order stable argsort and cumulative counts)
    on a CPU copy, with int32 and int64 indices, at the gathers' shapes
    (DGCNN's kNN, [TRAIN_B, 20480] rows into 1024 points, and PointNet++'s
    level 1), under heavy ties (every row of a cloud on 8 of 1024 points,
    and on one), with most targets empty (B clouds of SCATTER_N points in a
    64^2 plane's cells and in the grid's 32^3, the shared-memory tier's
    largest), in the device-memory tier (40,000 and 100,000 targets) and
    at ragged sizes (M not a multiple of the block's 1024 rows; M = 0).
    Timed at DGCNN's kNN shape: the device time of one build by the
    profiler over 20 calls, its whole call, the plain version on the card
    and, as the yardstick, one stable `torch.sort` of the same indices
    (which gives the rows alone); the bound counts the indices read once
    and the rows and offsets written once. -> the row."""
    from if_defense_tpu_torch.ops import cuda_csr

    sets = gather_sets(dev)
    knn = sets["dgcnn block 2 (C 64)"][1].reshape(TRAIN_B, -1)
    gen = torch.Generator(device=dev).manual_seed(25)
    cases = {
        "dgcnn kNN": (knn, 1024),
        "pointnet2 level 1": (sets["pointnet2 xyz (C 3)"][1].reshape(
            TRAIN_B, -1), 1024),
        "ties, 8 points a cloud": (sets["ties, 8 points a cloud (C 64)"][1]
                                   .reshape(TRAIN_B, -1), 1024),
        "ties, one point": (torch.full((TRAIN_B, 20480), 517, device=dev),
                            1024),
        "64^2 plane, most cells empty": (torch.randint(
            0, 4096, (B, SCATTER_N), generator=gen, device=dev), 4096),
        "grid 32^3": (torch.randint(0, 32**3, (B, SCATTER_N), generator=gen,
                                    device=dev), 32**3),
        "device tier, 40000": (torch.randint(
            0, 40000, (4, 20000), generator=gen, device=dev), 40000),
        "device tier, one of 100000": (torch.full((2, 5000), 99999,
                                                  device=dev), 100000),
        "ragged, M = 1500": (torch.randint(0, 70, (3, 1500), generator=gen,
                                           device=dev), 70),
        "M = 0": (torch.zeros((2, 0), dtype=torch.int64, device=dev), 9),
    }
    before = cuda_csr.launches["csr"]
    builds = 0
    for name, (idx, k) in cases.items():
        want = cuda_csr.csr_plain(idx.cpu(), k)
        same = True
        for dtype in (torch.int64, torch.int32):
            got = cuda_csr.build_csr(idx.to(dtype), k)
            builds += 1
            torch.cuda.synchronize()
            same &= (torch.equal(got.offsets.cpu(), want.offsets)
                     and torch.equal(got.rows.cpu(), want.rows))
        counts = want.offsets[:, 1:] - want.offsets[:, :-1]
        print(f"  CSR {name}: {tuple(idx.shape)} rows into {k} targets "
              f"({'shared' if k <= cuda_csr.SHARED_TARGETS else 'device'}"
              f"-memory tier), up to {int(counts.max()) if counts.numel() else 0}"
              f" rows a target, {int((counts == 0).sum())} targets empty; "
              f"int64 and int32 bit-equal to the stable argsort {same}")
        if not same:
            fail(f"the CSR build ({name}) is not the stable argsort's order")
    if cuda_csr.launches["csr"] - before != builds:
        fail(f"{cuda_csr.launches['csr'] - before} CSR launches for "
             f"{builds} builds")
    print(f"  CSR build, dgcnn kNN {tuple(knn.shape)} int64 into 1024:")
    m = knn.shape[1]
    times = kernel_times(
        lambda: cuda_csr.build_csr(knn, 1024),
        lambda: cuda_csr.csr_plain(knn, 1024),
        lambda: cuda_csr.build_csr(knn, 1024), None,
        (lambda: torch.sort(knn, dim=1, stable=True),
         lambda: torch.sort(knn, dim=1, stable=True)))
    bnd = bound(0, 8 * TRAIN_B * m + 4 * TRAIN_B * m + 4 * TRAIN_B * 1025)
    print(f"  plain (stable argsort, counts, cumsum) whole call "
          f"{times['plain_ms']:.4f} ms; one stable torch.sort device "
          f"{times['library_device_ms']:.4f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    row = dict(name="csr_build", id="csr.cu",
               source="if_defense_tpu_torch/csrc/csr.cu",
               replaces="none: the port's own, feeding gather.cu and "
                        "scatter.cu (no TPU kernel groups rows)",
               max_abs_err=0.0, bound=bnd, **times)
    print_row(row)
    return row


def check_gather_backward(dev) -> dict:
    """Phase 2's gather-backward kernel (`csrc/gather.cu`; no TPU kernel)
    at the victims' training shapes (`gather_sets`), each with int64 and
    int32 indices: `index_points`' gradient on the card, twice, bit-equal
    (every bit) to the plain version's autograd on a CPU copy, each
    backward one CSR build and one launch of the sums. Timed at DGCNN's
    second block (the row of the kernels' line), PointNet++'s level-1
    features and DGCNN's fourth block: the wrapper's device time (the CSR
    build and the sums) over 20 calls by the profiler, with its device
    operations a call, fed the gradient; its whole call with a harness
    loss, forward and backward; the plain version's (`torch.gather`, an
    atomic `scatter_add_` backward) and the same under deterministic
    algorithms (torch's sort-based index backward); and the device time of
    the two yardsticks alone: `scatter_add_` into zeros, atomic and under
    deterministic algorithms. The bound counts the output's gradient and
    the indices read once and the gradient written once. -> the row."""
    from if_defense_tpu_torch.ops import cuda_csr, cuda_gather
    from if_defense_tpu_torch.ops.pointops import (
        index_points,
        index_points_plain,
    )
    from if_defense_tpu_torch.utils.determinism import deterministic

    sets = gather_sets(dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    err, grads, timed = 0.0, {}, {}
    for name, (pts, idx) in sets.items():
        n, c = pts.shape[1:]
        g = torch.randn((*idx.shape, c), generator=gen, device=dev)
        x = pts.detach().cpu().clone().requires_grad_(True)
        index_points_plain(x, idx.cpu()).backward(g.cpu())
        reads = torch.zeros(TRAIN_B, n, dtype=torch.int64).scatter_add_(
            1, idx.reshape(TRAIN_B, -1).long().cpu(),
            torch.ones(idx.reshape(TRAIN_B, -1).shape, dtype=torch.int64))
        same = True
        for dtype in (torch.int64, torch.int32):
            before = cuda_gather.launches["gather_backward"]
            built = cuda_csr.launches["csr"]
            got = []
            for _ in range(2):
                xd = pts.detach().clone().requires_grad_(True)
                index_points(xd, idx.to(dtype)).backward(g)
                got.append(xd.grad)
            torch.cuda.synchronize()
            launched = (cuda_gather.launches["gather_backward"] - before,
                        cuda_csr.launches["csr"] - built)
            same &= launched == (2, 2) and all(same_bits(gr, x.grad)
                                               for gr in got)
            err = max(err, float((got[0].cpu() - x.grad).abs().max()))
        print(f"  gather backward, {name}: [{TRAIN_B}, {n}, {c}] at "
              f"{tuple(idx.shape)}, up to {int(reads.max())} rows a point, "
              f"{int((reads == 0).sum())} points read by none; int64 and "
              f"int32 indices, two launches each: bit-equal to the plain "
              f"version's autograd on a CPU copy {same}")
        if not same:
            fail(f"the gather-backward kernel ({name}) is not bit-equal to "
                 "the plain version's autograd on a CPU copy, or from launch "
                 "to launch, or did not launch once a backward")
        grads[name] = g

    def harness(fn, pts, idx, g):
        def call():
            x = pts.detach().requires_grad_(True)
            return torch.autograd.grad((fn(x, idx) * g).sum(), x)
        return call

    def determined(fn):
        def run():
            with deterministic():
                return fn()
        return run

    for name in ("dgcnn block 2 (C 64)", "pointnet2 level-1 features (C 128)",
                 "dgcnn block 4 (C 128)"):
        pts, idx = sets[name]
        g = grads[name]
        n, c = pts.shape[1:]
        flat = idx.reshape(TRAIN_B, -1)
        m = flat.shape[1]
        g3 = g.reshape(TRAIN_B, m, c)
        ixp = flat.long()[..., None].expand(-1, -1, c)

        def scatter(g3=g3, ixp=ixp, n=n, c=c):
            return torch.zeros((TRAIN_B, n, c), device=dev).scatter_add_(
                1, ixp, g3)

        print(f"  gather backward, {name}, {tuple(flat.shape)} "
              f"{str(idx.dtype).split('.')[-1]} indices:")
        times = kernel_times(
            harness(index_points, pts, idx, g),
            harness(index_points_plain, pts, idx, g),
            lambda: cuda_gather.gather_backward_cuda(g3, flat, n), None,
            (scatter, scatter))
        times["deterministic_plain_ms"] = median_ms(determined(
            harness(index_points_plain, pts, idx, g)))
        det = device_ms(determined(scatter))
        times["deterministic_device_ms"] = det[0] if det else graph_ms(
            determined(scatter))
        times["bound"] = bound(TRAIN_B * m * c, 4 * TRAIN_B * m * c
                               + idx.element_size() * TRAIN_B * m
                               + 4 * TRAIN_B * n * c)
        print(f"  plain (atomic backward) whole call {times['plain_ms']:.4f}"
              f" ms, under deterministic algorithms "
              f"{times['deterministic_plain_ms']:.4f} ms; scatter_add_ "
              f"device: atomic {times['library_device_ms']:.4f} ms, "
              f"deterministic {times['deterministic_device_ms']:.4f} ms "
              f"({', '.join(f'{k} {v:.4f}' for k, v in det[1].items()) if det else 'graph replay'}); "
              f"bound {times['bound'][0]:.4f} ms ({times['bound'][1]})")
        timed[name] = times
    row = dict(name="gather_backward", id="gather.cu",
               source="if_defense_tpu_torch/csrc/gather.cu",
               replaces="none: if_defense_tpu/ops/pointops.py:49 "
                        "index_points is XLA (p[i]), not a Pallas kernel",
               max_abs_err=err, **timed["dgcnn block 2 (C 64)"],
               shapes={k: {f: v[f] for f in (
                   "device_ms", "call_ms", "plain_ms",
                   "deterministic_plain_ms", "library_device_ms",
                   "deterministic_device_ms", "launches_per_call")}
                   | {"bound_ms": v["bound"][0]}
                   for k, v in timed.items()})
    print_row(row)
    return row


def print_row(r: dict) -> None:
    lib = r.get("library_device_ms")
    print(f"  {r['id']} {r['name']}: device {r['device_ms']:.4f} ms "
          f"(whole call {r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, share "
          f"{r['bound'][0] / r['device_ms']:.3f})"
          + (f", library device {lib:.4f} ms (whole call "
             f"{r['library_call_ms']:.4f})" if lib is not None else ""))


def check_small_path(dev) -> None:
    """The whole defense on a small input, CUDA (kernels) vs CPU (plain
    versions), same weights and draws: >= 99.9 % of coordinates within
    1e-4, all within 2 lr (steps + 1) (Adam's first steps move a coordinate
    by ~lr sign(g), and a gradient within rounding of 0 can flip it). At
    256 optimised points, and at 6000 (more than the 4096 the repulsion
    kernels once refused)."""
    from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import (
        init_params,
        params_from_jax,
    )

    cfg = dict(c_dim=16, hidden_dim=16, plane_resolution=32)
    sd = params_from_jax(init_params(3, c_dim=16, hidden_dim=16),
                         ConvOccupancyNetwork(**cfg))
    gen = np.random.default_rng(3)
    pc = gen.normal(size=(2, 512, 3)).astype(np.float32) * 0.3
    sel = gen.uniform(-0.4, 0.4, (2, 128, 3)).astype(np.float32)
    modes = {"reference": dict(),
             "fast f32": dict(interp_refresh=2, rep_graph_cache=True)}
    for npoint in (256, 6000):
        init = gen.uniform(-0.4, 0.4, (2, npoint, 3)).astype(np.float32)
        for name, extra in modes.items():
            outs = []
            for d in ("cpu", dev):
                model = ConvOccupancyNetwork(**cfg)
                model.load_state_dict(sd)
                model.to(d)
                defend = convonet_opt_defense(
                    model, iterations=SMALL_ITERS, input_npoint=128,
                    sample_npoint=npoint, **extra)
                draws = tuple(torch.from_numpy(a).to(d) for a in (sel, init))
                outs.append(defend(torch.from_numpy(pc).to(d),
                                   draws=draws).cpu())
            err = (outs[0] - outs[1]).abs()
            share = float((err <= 1e-4).float().mean())
            bound_ = 2 * LR * (SMALL_ITERS + 1)
            print(f"  {name}, {npoint} points: {share:.5f} of coordinates "
                  f"within 1e-4, max {float(err.max()):.3e} (bound {bound_:g})")
            if share < 0.999 or float(err.max()) > bound_:
                fail(f"small whole-path run ({name}, {npoint} points) "
                     "disagrees with the CPU run")


def check_opt_cli() -> tuple[dict, dict]:
    """Phase 4: `cli/opt_defense.py` at full width in both modes, each run
    twice, with the launch checks and each mode's repeat bit for bit. ->
    (clouds/s by run, launches by mode)."""
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.utils.params_io import (
        init_params,
        save_params_npz,
    )

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        pc = ellipsoids(np.random.default_rng(0), B)
        for name in ("reference", "fast"):
            save_npz(os.path.join(tmp, f"{name}.npz"),
                     {"test_pc": pc, "test_label": np.arange(B) % 40})
        save_params_npz(os.path.join(tmp, "weights.npz"), init_params(0))
        modes = {"reference": [],
                 "fast": ["--compute_dtype", "bfloat16",
                          "--interp_refresh", "16", "--rep_graph_cache"]}
        rates, restored = {}, {}
        for name, extra in modes.items():
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            zero_launches()
            run = run_cli(tmp, name, extra)
            rates[name], restored[name] = (run["clouds_per_sec"],
                                           run["restored"])
            launches[name] = all_launches()
            print(f"  {name}: launches "
                  f"{ {k: v for k, v in launches[name].items() if v} }")
        # B1 forward and backward a step, B4 once each way a step (three
        # planes a launch); the fast mode bypasses B4 (corner cache) and
        # builds B2's mask once per 16-step window (13 of 201 steps)
        # the encoder's scatter-mean once a plane for the one batch of 48,
        # its pooled max once a plane in each of 4 blocks, forward only,
        # all of a plane's calls on one CSR build (and one more a gather's
        # backward)
        ref, fast = launches["reference"], launches["fast"]
        if (ref["repulsion_loss"] != 402 or ref["plane_features"] != 201
                or ref["plane_features_dp"] != 201
                or ref["plane_features_dplane"]
                or fast["repulsion_loss_masked"] != 402
                or fast["repulsion_mask"] != 13
                or ref["scatter_mean"] != 3 or fast["scatter_mean"] != 3
                or any(m["pooled_max"] != 12 or m["pooled_max_backward"]
                       or m["csr"] != 3 + m["gather_backward"]
                       for m in (ref, fast))):
            fail(f"launches {launches} in ConvONet-Opt: not B1 402, B4 "
                 "201 + 201 and the scatter-mean 3 in the reference mode, "
                 "B3 402, B2 13 and the scatter-mean 3 in the fast mode, "
                 "and the pooled max 12 forward and no backward and 3 CSR "
                 "builds (one a plane, besides the gathers') in each")
        # a second, warm run of each mode for the rate, which repeats the
        # first's output bit for bit: the same --seed and data
        for name, extra in modes.items():
            warm = run_cli(tmp, name, extra)
            rates[name + " warm"] = warm["clouds_per_sec"]
            same = np.array_equal(warm.pop("restored"), restored[name])
            print(f"  {name}: the second run bit-equal to the first {same}")
            if not same:
                where = first_difference(tmp, name, extra)
                fail(f"two {name}-mode runs of cli/opt_defense.py with one "
                     f"--seed and file differ; first at {where}")
    return rates, launches


def first_difference(tmp: str, name: str, extra: list[str]) -> str:
    """Where two runs of `run_cli(tmp, name, extra)` part. Every module
    call's inputs and outputs are digested in call order (the encoder's
    layers on the draws, then the decoder's at each step) as the integer
    sums of their bits, which are exact in any order; then the restored
    clouds. -> the first tensor that differs: its module, call, role and
    shape."""
    from torch.nn.modules.module import register_module_forward_hook

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from tensors(v)
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)

    def digest(t):
        t = t.detach().reshape(-1)
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()])
        return t.sum(dtype=torch.int64)

    runs = []
    for _ in range(2):
        seen, calls = [], {}

        def hook(module, args, output):
            kind = type(module).__name__
            calls[kind] = calls.get(kind, 0) + 1
            for role, x in (("input", args), ("output", output)):
                for i, t in enumerate(tensors(x)):
                    seen.append((f"{kind} call {calls[kind]} {role} {i} "
                                 f"{tuple(t.shape)}", digest(t)))

        handle = register_module_forward_hook(hook)
        try:
            restored = run_cli(tmp, name, extra)["restored"]
        finally:
            handle.remove()
        labels = [label for label, _ in seen]
        values = torch.stack([d for _, d in seen]).cpu().tolist()
        runs.append((labels, values, restored))
    (la, va, ra), (lb, vb, rb) = runs
    for i, (a, b) in enumerate(zip(la, lb)):
        if a != b or va[i] != vb[i]:
            return a if a == b else f"{a} / {b} (the call order)"
    if len(la) != len(lb):
        return f"the module calls: {len(la)} against {len(lb)}"
    if not np.array_equal(ra, rb):
        return ("the restored clouds (every module call equal: the Adam "
                "steps or the repulsion outside the modules)")
    return "none: the two diagnostic runs were bit-equal"


def run_cli(tmp: str, name: str, extra: list[str],
            weights: str | None = None) -> dict:
    """`cli/opt_defense.py` at phase 4's settings on `<tmp>/<name>.npz`;
    its metrics record and the restored clouds (`restored`)."""
    from if_defense_tpu_torch.cli import opt_defense
    from if_defense_tpu_torch.data import load_npz

    data = os.path.join(tmp, f"{name}.npz")
    out_path, = opt_defense.main([
        "--data_root", data,
        "--weights", weights or os.path.join(tmp, "weights.npz"),
        "--batch_size", str(B), "--iterations", "200",
        "--sample_npoint", "1024", "--seed", "1", "--device", "cuda",
        *extra])
    with open(out_path + ".metrics.jsonl") as f:
        metrics = json.loads(f.read().splitlines()[-1])
    out = load_npz(out_path).test_pc
    radius = float(np.sqrt((out**2).sum(-1)).max())
    print(f"  {name}: output {out.shape}, max radius {radius:.7f}, "
          f"occupancy loss {metrics['occ_loss_first']:.4f} -> "
          f"{metrics['occ_loss_last']:.4f}, "
          f"{metrics['clouds_per_sec']:.3f} clouds/s")
    if out.shape != (B, 1024, 3) or not np.isfinite(out).all():
        fail(f"{name}: output shape {out.shape} or non-finite values")
    if radius > 1 + 1e-5:
        fail(f"{name}: max radius {radius} > 1 + 1e-5")
    if not metrics["occ_loss_last"] < metrics["occ_loss_first"]:
        fail(f"{name}: occupancy loss did not fall")
    return {**metrics, "restored": out}


def sa_level_inputs(dev, clouds: np.ndarray):
    """PU-Net's set-abstraction inputs for one batch of the CLI's clouds:
    SOR, resampling to 1024, then the chain of FPS levels (plain version).
    -> [(points [B, N, 3], centres [B, S, 3], radius)] per level."""
    from if_defense_tpu_torch.defense import process_data_fixed, sor_defense
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        index_points,
    )

    pc, mask = sor_defense(torch.from_numpy(clouds).to(dev))
    xyz = process_data_fixed(pc, mask, 1024,
                             torch.Generator(device=dev).manual_seed(0))
    levels = []
    for npoint, radius in SA_LEVELS:
        new = index_points(xyz, farthest_point_sample_plain(xyz, npoint))
        levels.append((xyz, new, radius))
        xyz = new
    return levels


def victim_level_inputs(dev, clouds: np.ndarray):
    """The victims' ball-query inputs: the first VICTIM_B clouds normalised
    to the unit sphere, each level's centres by FPS (plain version) of its
    points. -> [(name, points [B, N, 3], centres [B, S, 3], radius,
    nsample)]."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        index_points,
        normalize_unit_sphere,
    )

    x0 = normalize_unit_sphere(torch.from_numpy(clouds[:VICTIM_B]).to(dev))
    out = []
    for model, levels in VICTIM_LEVELS:
        xyz = x0
        for i, (npoint, radius, nsample) in enumerate(levels):
            new = index_points(xyz, farthest_point_sample_plain(xyz, npoint))
            out.append((f"{model} SA{i + 1}", xyz, new, radius, nsample))
            xyz = new
    return out


def ballquery_work(xyz, new, radius: float, nsample: int):
    """(flops, bytes, mean points scanned a centre) of a ball query on these
    inputs: a centre scans up to its nsample-th hit, which is its last slot
    when that slot differs from slot 0, else the whole cloud."""
    from if_defense_tpu_torch.ops import query_ball_point_plain

    b, n, _ = xyz.shape
    s = new.shape[1]
    idx = query_ball_point_plain(radius, nsample, xyz, new)
    scanned = torch.where(idx[..., -1] != idx[..., 0], idx[..., -1] + 1, n)
    return (9 * float(scanned.sum()) + 5 * b * (n + s),
            12 * b * (n + s) + 4 * b * s * nsample,
            float(scanned.float().mean()))


def check_pointops(dev, clouds: np.ndarray) -> list[dict]:
    """B5 and B6 against their plain versions at each SA level, unmasked
    and masked (~90 % valid, the last cloud with none): indices bit-equal.
    Times are of unmasked calls (`kernel_times`); a row's numbers are sums
    over the four levels (one batch of the path). Then the large clouds
    (`check_pointops_large`)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    # per kernel: times, flops and bytes, summed over the levels
    tot = {k: dict.fromkeys(("call_ms", "plain_ms", "device_ms", "graph_ms",
                             "flops", "bytes"), 0.0)
           for k in ("fps", "ballquery")}
    with SmClock() as clock:
        levels = check_sa_levels(dev, clouds, gen, tot)
    rows = []
    for k, rid, src, rep_ in (
            ("fps", "B5", "fps.cu", "pallas_fps.py:82"),
            ("ballquery", "B6", "ballquery.cu", "pallas_ballquery.py:71")):
        t = tot[k]
        rows.append(dict(
            name=k, id=rid, source=f"if_defense_tpu_torch/csrc/{src}",
            replaces=f"if_defense_tpu/ops/{rep_}", max_abs_err=0.0,
            call_ms=t["call_ms"], plain_ms=t["plain_ms"],
            device_ms=t["device_ms"], graph_ms=t["graph_ms"],
            library_call_ms=None, library_device_ms=None,
            bound=bound(t["flops"], t["bytes"])))
        print(f"  {rid}, summed over the 4 levels:")
        print_row(rows[-1])
    steps = sum(s for _, s in levels)
    print(f"  B5 per step: {tot['fps']['device_ms']:.4f} ms over {steps} "
          f"dependent steps = {1e3 * tot['fps']['device_ms'] / steps:.4f} us "
          f"a step ({clock.text()}, sampled while phase 5's levels ran)")
    check_victim_levels(dev, clouds)
    check_pointops_large(dev)
    return rows


def check_sa_levels(dev, clouds: np.ndarray, gen, tot: dict) -> list:
    """check_pointops' work at each SA level: the bit-equality checks and
    the timings, summed into `tot`. -> [(N, steps)] per level."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        query_ball_point_plain,
    )
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    levels = []
    for level, (xyz, new, radius) in enumerate(sa_level_inputs(dev, clouds)):
        b, n, _ = xyz.shape
        s = new.shape[1]
        mask = torch.rand((b, n), generator=gen, device=dev) > 0.1
        mask[-1] = False
        for tag, m in (("unmasked", None), ("masked", mask)):
            diff = int((fps_cuda(xyz, s, mask=m) != farthest_point_sample_plain(
                xyz, s, mask=m)).sum())
            diff += int((ballquery_cuda(radius, 32, xyz, new, m)
                         != query_ball_point_plain(radius, 32, xyz, new, m))
                        .sum())
            print(f"  level {level} [{b}, {n}] -> {s} {tag}: {diff} indices "
                  "differ (bit-equal required)")
            if diff:
                fail(f"B5/B6 disagree with their plain versions at level "
                     f"{level} ({tag})")
        bq_flops, bq_bytes, scanned = ballquery_work(xyz, new, radius, 32)
        work = {"fps": (10 * b * n * s, 12 * b * n + 4 * b * s),
                "ballquery": (bq_flops, bq_bytes)}
        calls = {
            "fps": (lambda: fps_cuda(xyz, s),
                    lambda: farthest_point_sample_plain(xyz, s),
                    ("fps_kernel", "fps_kernel_global")),
            "ballquery": (lambda: ballquery_cuda(radius, 32, xyz, new),
                          lambda: query_ball_point_plain(radius, 32, xyz, new),
                          ("ballquery_kernel",))}
        for k, (kern, plain, names) in calls.items():
            print(f"  level {level} {k}:")
            t = kernel_times(kern, plain, kern, names)
            bound_ms, by = bound(*work[k])
            print(f"  level {level} {k}: device {t['device_ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({by})")
            for key in ("call_ms", "plain_ms", "device_ms", "graph_ms"):
                tot[k][key] += t[key]
            tot[k]["flops"] += work[k][0]
            tot[k]["bytes"] += work[k][1]
        print(f"  level {level}: a centre scans {scanned:.1f} of {n} points "
              "on average")
        levels.append((n, s))
    return levels


def check_victim_levels(dev, clouds: np.ndarray) -> None:
    """B5 and B6 at the victims' set-abstraction shapes
    (`victim_level_inputs`; PointConv samples at the same shapes), unmasked
    and masked (~90 % valid, the last cloud with none): indices bit-equal
    to the plain versions, so B5's centres come in the plain version's
    order; B6 timed like a level of `check_sa_levels`, for information (not
    summed into the B6 row)."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        query_ball_point_plain,
    )
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    for name, xyz, new, radius, ns in victim_level_inputs(dev, clouds):
        b, n, _ = xyz.shape
        s = new.shape[1]
        mask = torch.rand((b, n), generator=gen, device=dev) > 0.1
        mask[-1] = False
        for tag, m in (("unmasked", None), ("masked", mask)):
            fps_diff = int((fps_cuda(xyz, s, mask=m)
                            != farthest_point_sample_plain(xyz, s, mask=m))
                           .sum())
            bq_diff = int((ballquery_cuda(radius, ns, xyz, new, m)
                           != query_ball_point_plain(radius, ns, xyz, new, m))
                          .sum())
            print(f"  {name} [{b}, {n}] -> {s}, r {radius}, nsample {ns} "
                  f"{tag}: {fps_diff} B5 and {bq_diff} B6 indices differ "
                  "(bit-equal required)")
            if fps_diff:
                fail(f"B5 disagrees with its plain version at {name} ({tag})")
            if bq_diff:
                fail(f"B6 disagrees with its plain version at {name} ({tag})")
        flops, nbytes, scanned = ballquery_work(xyz, new, radius, ns)
        print(f"  {name} ballquery:")
        t = kernel_times(lambda: ballquery_cuda(radius, ns, xyz, new),
                         lambda: query_ball_point_plain(radius, ns, xyz, new),
                         lambda: ballquery_cuda(radius, ns, xyz, new),
                         ("ballquery_kernel",))
        bound_ms, by = bound(flops, nbytes)
        print(f"  {name} ballquery: device {t['device_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by}, share "
              f"{bound_ms / t['device_ms']:.3f}); a centre scans "
              f"{scanned:.1f} of {n} points on average")


def check_pointops_large(dev) -> None:
    """B5 and B6 past the sizes their kernels keep in registers and shared
    memory: B5 at N = 16385 and 40000 (B=2, npoint 512; unmasked, masked,
    from `start_idx`), B6 at N = 12289 and 40000 (B=2, the first 512 points
    as centres, 32 slots, radius 0.05; unmasked and masked). Indices
    bit-equal to the plain versions; each call timed for information: the
    median of 3 CUDA-event timings of one whole call (the profiler has
    missed these long single launches; the host's share of a call of
    milliseconds is small)."""
    from if_defense_tpu_torch.ops import (
        farthest_point_sample_plain,
        query_ball_point_plain,
    )
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    gen = np.random.default_rng(9)
    cases = [("fps", n) for n in (16385, 40000)] + [
        ("ballquery", n) for n in (12289, 40000)]
    for kernel, n in cases:
        x = torch.from_numpy((gen.normal(size=(2, n, 3)) * 0.3).astype(
            np.float32)).to(dev)
        mask = torch.from_numpy(gen.uniform(size=(2, n)) > 0.1).to(dev)
        start = torch.tensor([n - 1, n // 3], device=dev)
        q = x[:, :512].contiguous()
        if kernel == "fps":
            calls = {tag: (lambda m=m, st=st: fps_cuda(x, 512, st, m),
                           lambda m=m, st=st: farthest_point_sample_plain(
                               x, 512, st, m))
                     for tag, m, st in (("unmasked", None, None),
                                        ("masked", mask, None),
                                        ("start_idx", None, start))}
        else:
            calls = {tag: (lambda m=m: ballquery_cuda(0.05, 32, x, q, m),
                           lambda m=m: query_ball_point_plain(0.05, 32, x, q,
                                                              m))
                     for tag, m in (("unmasked", None), ("masked", mask))}
        for tag, (kern, plain) in calls.items():
            diff = int((kern() != plain()).sum())
            print(f"  {kernel} [2, {n}] {tag}: {diff} indices differ "
                  f"(bit-equal required), one call {median_ms(kern, 3):.4f} "
                  "ms (CUDA events)")
            if diff:
                fail(f"{kernel} at N={n} ({tag}) disagrees with its plain "
                     "version")


def load_punet(device):
    from if_defense_tpu_torch.cli.defend_npz import DEFAULT_PUNET_WEIGHTS
    from if_defense_tpu_torch.defense import DUPNet
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )

    dup = DUPNet(npoint=1024, up_ratio=4)
    dup.pu_net.load_state_dict(
        params_from_jax(load_params_npz(DEFAULT_PUNET_WEIGHTS), dup.pu_net))
    return dup.to(device).eval()


def check_small_dupnet(dev) -> None:
    """DUP-Net, CUDA (kernels) vs CPU (plain versions), same weights and
    resampling draws: >= 99.9 % of coordinates within 1e-4, all within
    1e-3. FPS and ball query pick the same indices on both devices, so
    only the f32 matmuls round differently."""
    gen = np.random.default_rng(4)
    pc = ellipsoids(gen, 2)
    u = gen.uniform(size=(2, 1024)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        with torch.inference_mode():
            outs.append(load_punet(d)(torch.from_numpy(pc).to(d),
                                      u=torch.from_numpy(u).to(d)).cpu())
    err = (outs[0] - outs[1]).abs()
    share = float((err <= 1e-4).float().mean())
    print(f"  output {tuple(outs[1].shape)}: {share:.5f} of coordinates "
          f"within 1e-4, max {float(err.max()):.3e} (bound 1e-3)")
    if share < 0.999 or float(err.max()) > 1e-3:
        fail("small DUP-Net run disagrees with the CPU run")


def nearness(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Per cloud: mean distance of an output point to its nearest input
    point over the input's mean nearest-neighbour spacing."""
    ratios = []
    for o, p in zip(out.split(32), inp.split(32)):
        near = torch.cdist(o, p).amin(-1).mean(-1)
        self_d = torch.cdist(p, p)
        self_d.diagonal(dim1=1, dim2=2).fill_(float("inf"))
        ratios.append(near / self_d.amin(-1).mean(-1))
    return torch.cat(ratios)


def run_defend_npz(dev, tmp: str, clouds: np.ndarray) -> tuple[dict, dict]:
    """The CLI at full width: DUP-Net (first run, launch counters zeroed
    just before and read just after), all three defenses (outputs checked),
    DUP-Net again (warm). -> (launches, clouds/s)."""
    from if_defense_tpu_torch.cli import defend_npz
    from if_defense_tpu_torch.data import load_npz, save_npz
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps

    data = save_npz(os.path.join(tmp, "adv.npz"),
                    {"test_pc": clouds,
                     "test_label": np.arange(len(clouds)) % 40})
    argv = ["--data_root", data, "--device", "cuda"]

    def timed(extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = defend_npz.main(argv + extra)
        torch.cuda.synchronize()
        return paths, time.perf_counter() - t0

    counters = (cuda_fps.launches, cuda_ballquery.launches)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    _, first = timed(["--defense", "dup"])
    launches = {k: v for c in counters for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  DUP-Net first run: {first:.3f} s, launches {launches}, peak "
          f"device memory {peak:.2f} GiB")
    # 4 SA levels a batch, 2 batches of DUP_B
    want = 4 * DUP_CLOUDS // DUP_B
    if launches != {"fps": want, "ballquery": want}:
        fail(f"B5/B6 launches {launches} on the DUP-Net path, not {want} "
             "each")
    paths, seconds = timed([])
    print(f"  all three defenses: {seconds:.3f} s")
    shapes = {"srs": (len(clouds), 1024 - 500, 3), "sor": (len(clouds), 1024, 3),
              "dup": (len(clouds), 4096, 3)}
    for path, (name, shape) in zip(paths, shapes.items()):
        got = load_npz(path)
        print(f"  {name}: {os.path.relpath(path, tmp)} {got.test_pc.shape}")
        if (got.test_pc.shape != shape or not np.isfinite(got.test_pc).all()
                or not os.path.basename(path) == f"{name}_adv.npz"):
            fail(f"{name}: output {path} {got.test_pc.shape} or non-finite")
        if name == "dup":
            ratio = nearness(torch.from_numpy(got.test_pc).to(dev),
                             torch.from_numpy(clouds).to(dev))
            print(f"  dup: nearest-input distance / input spacing, per "
                  f"cloud: max {float(ratio.max()):.3f}, mean "
                  f"{float(ratio.mean()):.3f} (limit {NEAR_FACTOR})")
            if float(ratio.max()) >= NEAR_FACTOR:
                fail("DUP-Net output points lie far from their input cloud")
    _, warm = timed(["--defense", "dup"])
    rates = {"first": len(clouds) / first, "warm": len(clouds) / warm}
    return launches, rates


def profile_dupnet(dev, clouds: np.ndarray) -> None:
    """torch.profiler over one warm batch of DUP-Net (the module, as the
    CLI calls it): wall time, device kernel time and busy share, B5 and
    B6's share, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    dup = load_punet(dev)
    x = torch.from_numpy(clouds).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        dup(x, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dup(x, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"  profile: wall {wall:.3f} ms; device time not measured "
              "(the profiler saw no CUDA kernel)")
        return
    ours = sum(e.self_device_time_total for e in events
               if "fps_kernel" in e.key or "ballquery_kernel" in e.key) / 1e3
    print(f"  profile, one batch of {len(clouds)}: wall {wall:.3f} ms, "
          f"device kernels {busy:.3f} ms (busy share {busy / wall:.3f}), "
          f"B5 + B6 {ours:.3f} ms ({ours / busy:.3f} of device time)")
    print_top(events, 8)


def plane_inputs(dev, gen, b: int, q: int):
    """Three N(0, 1) planes [b, R, R, C], points from [-0.6, 0.6]^3 (the
    normalisation clamps about one coordinate in ten) and the output's
    cotangent, f32."""
    def dev_(shape, lo=None):
        a = (gen.normal(size=shape) if lo is None
             else gen.uniform(-lo, lo, shape))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    planes = {n: dev_((b, R, R, C)) for n in PLANE_NAMES}
    return dev_((b, q, 3), 0.6), planes, dev_((b, q, C))


def touched_rows(p: torch.Tensor, planes: dict) -> int:
    """Distinct corner rows ([C] channels of one cell) that the queries of
    every cloud touch, summed over the planes and clouds: the plane bytes a
    call must read, C x 4 each."""
    from if_defense_tpu_torch.ops import interp

    total = 0
    for name, plane in planes.items():
        b, h, w, _ = plane.shape
        uv = interp.normalize_coordinate(p, name)
        x0 = (uv[..., 0] * (w - 1)).floor().long()
        y0 = (uv[..., 1] * (h - 1)).floor().long()
        x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
        cells = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0,
                           y1 * w + x1], 1)
        hit = torch.zeros((b, h * w), dtype=torch.bool, device=p.device)
        total += int(hit.scatter_(1, cells, True).sum())
    return total


def check_plane_features(dev, gen, b: int, q: int, train: bool) -> dict:
    """B4 (`plane_features_cuda`, three planes) against its plain version
    (`ops.interp.plane_features`), one form: the defense's (forward +
    gradient to p) or training's (forward + the planes' gradients; also
    with the gradient to p). f32: output atol 1e-5 of the largest entry,
    gradient to p rtol 1e-4 with atol 1e-5 of the largest entry, the
    planes' gradients atol 1e-5 of the largest entry (sums in other
    orders); bf16 p and planes against the plain version on f32 copies,
    cast once (the kernel's math is f32; the plain version in bf16
    normalises in bf16), rtol 2^-7. Two launches bit-identical. Times the
    form's call, its plain version and three `F.grid_sample` calls summed,
    with the gradient to their grids (defense) or inputs (training)."""
    from if_defense_tpu_torch.ops import cuda_interp, interp

    p, planes, g_out = plane_inputs(dev, gen, b, q)
    want_p, want_planes = not train, train

    def grads(fn, pp, pls, wp, wpl, harness=True):
        pp = pp.detach().requires_grad_(wp)
        pls = {n: t.detach().requires_grad_(wpl) for n, t in pls.items()}
        out = fn(pp, pls)
        wrt = ([pp] if wp else []) + (list(pls.values()) if wpl else [])
        if not wrt:
            return [out.detach()]
        g = (torch.autograd.grad((out.float() * g_out).sum(), wrt) if harness
             else torch.autograd.grad(out, wrt, g_out.to(out.dtype)))
        return [out.detach(), *g]

    def kern(pp, pls):
        return cuda_interp.plane_features_cuda(pp, pls)

    def plain(pp, pls):       # the kernel's semantics: f32 math, cast once
        dt = next(iter(pls.values())).dtype
        return interp.plane_features(
            pp.float(), {n: t.float() for n, t in pls.items()}).to(dt)

    def tag_of(i, wp):
        return "out" if i == 0 else ("dp" if wp and i == 1 else
                                     f"d{PLANE_NAMES[i - 1 - wp]}")

    errs = []
    cases = [(want_p, want_planes)] + ([(True, True)] if train else [])
    for dt, rtol in ((torch.float32, 0.0), (torch.bfloat16, 2.0**-7)):
        pd = p.to(dt)
        pls = {n: t.to(dt) for n, t in planes.items()}
        for wp, wpl in cases:
            got = grads(kern, pd, pls, wp, wpl)
            want = grads(plain, pd, pls, wp, wpl)
            again = grads(kern, pd, pls, wp, wpl)
            for i, (a, w_, a2) in enumerate(zip(got, want, again)):
                tag = f"{tag_of(i, wp)} {str(dt).split('.')[-1]}" + (
                    " (with dp)" if train and wp else "")
                r = (1e-4 if dt == torch.float32 else rtol) if (
                    wp and i == 1) else rtol
                e = compare(tag, a, w_, 1e-5 * float(w_.float().abs().max()),
                            r)
                if dt == torch.float32:
                    errs.append(e)
                if not torch.equal(a, a2):
                    fail(f"B4 {tag}: two launches differ")
    print(f"  two launches bit-identical; "
          f"{int(((p.abs() / 1.10001) > 0.5).any(-1).sum())} of {b * q} "
          "queries clamped on some axis")

    # the yardstick: three F.grid_sample calls (NCHW views of the planes,
    # grids in [-1, 1] from the normalised coordinates), summed
    nchw = {n: t.permute(0, 3, 1, 2) for n, t in planes.items()}
    grids = {n: (2 * interp.normalize_coordinate(p, n) - 1)[:, None]
             for n in planes}
    g_nchw = g_out.permute(0, 2, 1)[:, :, None, :]

    def library(harness=True):
        xs = {n: (t.detach().requires_grad_(True) if train else t)
              for n, t in nchw.items()}
        gs = {n: (t if train else t.detach().requires_grad_(True))
              for n, t in grids.items()}
        out = sum(torch.nn.functional.grid_sample(
            xs[n], gs[n], mode="bilinear", padding_mode="border",
            align_corners=True) for n in planes)
        wrt = list((xs if train else gs).values())
        if harness:
            return out, torch.autograd.grad((out * g_nchw).sum(), wrt)
        return torch.autograd.grad(out, wrt, g_nchw)

    diff = float((library()[0].detach()[:, :, 0].transpose(1, 2)
                  - grads(plain, p, planes, False, False)[0]).abs().max())
    print(f"  three grid_sample calls vs plain: max abs diff {diff:.3e}")
    rows_hit = touched_rows(p, planes)
    per_q = 12 + 2 * 4 * C        # p read, g read, output written
    nbytes = 4 * rows_hit * C + b * q * (per_q + (0 if train else 12))
    whole = 3 * 4 * b * R * R * C
    if train:                     # every cell of the three planes written
        nbytes += whole
    flops = 3 * b * q * C * (10 + (10 if train else 12))
    b_touched = bound(flops, nbytes)
    b_whole = bound(flops, nbytes - 4 * rows_hit * C + whole)
    print(f"  bound: {rows_hit} of {3 * b * R * R} corner rows touched, "
          f"{b_touched[0]:.4f} ms ({b_touched[1]}); with whole planes read "
          f"{b_whole[0]:.4f} ms ({b_whole[1]})")
    names = ("features_fwd", "features_dplane" if train else "features_dp")
    print(f"  B4 {'training' if train else 'defense'} call, f32:")
    row = dict(
        name="plane_features_dplane" if train else "plane_features", id="B4",
        source="if_defense_tpu_torch/csrc/interp.cu",
        replaces="if_defense_tpu/ops/pallas_interp.py:"
                 + ("74" if train else "233"),
        max_abs_err=max(errs), bound=b_touched, bound_whole_ms=b_whole[0],
        **kernel_times(
            lambda: grads(kern, p, planes, want_p, want_planes),
            lambda: grads(interp.plane_features, p, planes, want_p,
                          want_planes),
            lambda: grads(kern, p, planes, want_p, want_planes, False),
            names, library=(library, lambda: library(False))))
    print_row(row)
    return row


def perturbed(tree: dict, seed: int) -> dict:
    """Every tensor moved off its init (flax zero-initialises each block's
    fc_1 and the CBN kernels): kernels by 0.3/sqrt(fan_in), other tensors
    by 0.05, running variances scaled by exp(0.2 N(0, 1))."""
    from if_defense_tpu_torch.utils.params_io import (
        flatten_params,
        unflatten_params,
    )

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(tree).items():
        n = rng.normal(size=v.shape)
        if k.endswith("/var"):
            v = v * np.exp(0.2 * n)
        else:
            v = v + (0.3 / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                     else 0.05) * n
        out[k] = v.astype(np.float32)
    return unflatten_params(out)


def small_models():
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )

    return {"convonet c8 16x16": lambda: ConvOccupancyNetwork(8, 8, 16),
            "onet c32 h32 d16": lambda: OccupancyNetwork(32, 32, 16)}


def check_small_training(dev, occ_npz: str) -> None:
    """3 training steps on the card and on the CPU from the same
    `perturbed(flax_init_params)` and sampler batches (B=4, 256 input
    points, 512 queries, lr 1e-4): step 1's loss within rtol 1e-5, its
    gradients within rtol 1e-4 and atol 1e-4 of each tensor's largest entry
    (a tensor whose gradient is 0 up to rounding, as a bias before a batch
    norm, stays so), the 3 losses within rtol 1e-4.

    The weights are perturbed because flax's zero biases put the UNet's
    pre-activations over every empty plane cell exactly at ReLU's kink,
    where the last bit of rounding decides whether a gradient passes, and
    the card and the CPU then route a whole region's gradient differently."""
    from if_defense_tpu_torch.implicit.training import (
        OccupancyBatchSampler,
        init_occupancy_model,
        make_occupancy_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    with np.load(occ_npz) as z:
        arrays = (z["pointcloud"][:8], z["points"][:8], z["points_occ"][:8])
    for name, make in small_models().items():
        sampler = OccupancyBatchSampler(*arrays, pointcloud_n=256,
                                        points_subsample=512, seed=0)
        batches = [sampler.sample(4) for _ in range(3)]
        runs = []
        for d in ("cpu", dev):
            model = make()
            model.load_state_dict(params_from_jax(
                perturbed(init_occupancy_model(model, 0), 1), model))
            model.to(d)
            _, step = make_occupancy_train_step(model, 1e-4)
            losses = []
            for i, b in enumerate(batches):
                losses.append(float(step(*(torch.from_numpy(a).to(d)
                                           for a in b))["loss"]))
                if i == 0:
                    grads = {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}
            runs.append((losses, grads))
        (lc, gc), (lg, gg) = runs
        zero = 1e-6 * max(float(g.abs().max()) for g in gc.values())
        worst = 0.0
        for n, ref in gc.items():
            top = float(ref.abs().max())
            if top < zero:
                if float(gg[n].abs().max()) >= zero:
                    fail(f"{name}: gradient of {n} is 0 on the CPU only")
                continue
            err = (gg[n] - ref).abs() / (1e-4 * top + 1e-4 * ref.abs())
            worst = max(worst, float(err.max()))
        print(f"  {name}: losses CPU {lc}, card {lg}; step-1 gradients of "
              f"{len(gc)} tensors, worst error / bound {worst:.3f}")
        if abs(lg[0] - lc[0]) > 1e-5 * abs(lc[0]) or worst > 1 or any(
                abs(a - b) > 1e-4 * abs(a) for a, b in zip(lc, lg)):
            fail(f"{name}: training on the card disagrees with the CPU run")


def build_occupancy_npz(tmp: str) -> str:
    path = os.path.join(tmp, "occ.npz")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "build_occupancy_dataset.py"),
         "--synthetic", "64", "--surface_n", "3000", "--query_n", "10000",
         "--out", path], check=True, timeout=300, stdout=subprocess.DEVNULL)
    return path


def run_train_cli(tmp: str, occ_npz: str, variant: str, tag: str) -> dict:
    """One `train_implicit` run at full width: losses finite, the last
    logged loss below the first, the npz loads strictly."""
    from if_defense_tpu_torch.cli import train_implicit
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        OccupancyNetwork,
    )
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )

    out = os.path.join(tmp, f"{variant}_{tag}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = train_implicit.main([
        "--variant", variant, "--data", occ_npz, "--steps", str(TRAIN_STEPS),
        "--lr", str(TRAIN_LR), "--log_every", "10", "--output", out,
        "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with open(out + ".metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    model = ConvOccupancyNetwork() if variant == "convonet" else OccupancyNetwork()
    model.load_state_dict(params_from_jax(load_params_npz(path), model),
                          strict=True)
    rate = records[-1]["steps_per_sec"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {variant} {tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(acc {records[0]['acc']:.3f} -> {records[-1]['acc']:.3f}), "
          f"{rate:.2f} steps/s (metrics), {seconds:.2f} s around main(), "
          f"peak device memory {peak:.2f} GiB")
    if len(records) != TRAIN_STEPS // 10 or not np.isfinite(losses).all():
        fail(f"{variant} {tag}: {len(records)} metrics lines or non-finite")
    if not losses[-1] < losses[0]:
        fail(f"{variant} {tag}: training loss did not fall")
    return dict(path=path, steps_per_sec=rate)


def profile_training(dev, occ_npz: str,
                     plane_type=("xz", "xy", "yz")) -> dict:
    """torch.profiler over 5 warm ConvONet training steps at the CLI's
    defaults (`plane_type=("grid",)`: the grid ConvONet) in each of the
    three settings of `utils.determinism.setting`, one after another, 2
    warm steps before each pass: `deterministic` as the CLI runs, `no
    fill` the same without the NaN fill of each new tensor, and `free`
    with deterministic algorithms off. Per setting and step: wall
    ms (host clock around the synchronised pass), device ms, device
    operations and the sorts among them; B4's share and the kernels that
    take the most device time under `deterministic`. -> {setting: [those
    figures of each pass]}."""
    from torch.profiler import ProfilerActivity, profile

    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.implicit.training import (
        OccupancyBatchSampler,
        init_occupancy_model,
        make_occupancy_train_step,
    )
    from if_defense_tpu_torch.utils.determinism import SETTINGS, setting

    with np.load(occ_npz) as z:
        sampler = OccupancyBatchSampler(z["pointcloud"], z["points"],
                                        z["points_occ"], pointcloud_n=600,
                                        points_subsample=TQ, seed=1)
    model = ConvOccupancyNetwork(plane_type=plane_type)
    init_occupancy_model(model, 1)
    model.to(dev)
    _, step = make_occupancy_train_step(model, TRAIN_LR)
    batches = [[torch.from_numpy(a).to(dev) for a in sampler.sample(TB)]
               for _ in range(7)]
    out = {name: [] for name in SETTINGS}
    top = None
    for name in SETTINGS:
        with setting(name):
            for b in batches[:2]:
                step(*b)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b in batches[2:]:
                    step(*b)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        n = len(batches) - 2
        out[name].append(dict(
            wall_ms=wall / n,
            device_ms=sum(e.self_device_time_total for e in events) / 1e3 / n,
            device_ops=sum(e.count for e in events) / n,
            sort_ops=sum(e.count for e in events
                         if "sort" in e.key.lower()) / n))
        if name == "deterministic" and top is None:
            top = events
    tag = "grid" if plane_type == ("grid",) else "plane"
    for name, got in out.items():
        print(f"  profile, {tag} ConvONet step (batch {TB}), {name}: "
              + "; ".join(f"wall {g['wall_ms']:.3f} ms, device "
                          f"{g['device_ms']:.3f} ms, {g['device_ops']:g} "
                          f"device operations ({g['sort_ops']:g} sorts)"
                          for g in got))
    if not top:
        print("  device time not measured (the profiler saw no CUDA kernel)")
        return out
    busy = sum(e.self_device_time_total for e in top)
    ours = sum(e.self_device_time_total for e in top
               if "features_fwd" in e.key or "features_dplane" in e.key)
    print(f"  deterministic: B4 fwd + plane grad {ours / busy:.3f} of device "
          "time; the kernels that take the most, over 5 steps:")
    print_top(top, 10)
    return out


def check_small_onet_opt(dev) -> None:
    """ONet-Opt on a small input, CUDA (kernels) vs CPU (plain versions),
    same perturbed weights and draws; the bound of phase 3."""
    from if_defense_tpu_torch.defense.ifdefense import onet_opt_defense
    from if_defense_tpu_torch.implicit import OccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    sd = params_from_jax(perturbed(flax_init_params(
        3, "onet", c_dim=32, hidden_dim=32, decoder_hidden=16), 4),
        OccupancyNetwork(32, 32, 16))
    gen = np.random.default_rng(5)
    pc = gen.normal(size=(2, 512, 3)).astype(np.float32) * 0.3
    sel = gen.uniform(-0.4, 0.4, (2, 128, 3)).astype(np.float32)
    init = gen.uniform(-0.4, 0.4, (2, 256, 3)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        model = OccupancyNetwork(32, 32, 16)
        model.load_state_dict(sd)
        defend = onet_opt_defense(model.to(d), iterations=SMALL_ITERS,
                                  input_npoint=128, sample_npoint=256)
        draws = tuple(torch.from_numpy(a).to(d) for a in (sel, init))
        outs.append(defend(torch.from_numpy(pc).to(d), draws=draws).cpu())
    err = (outs[0] - outs[1]).abs()
    share = float((err <= 1e-4).float().mean())
    print(f"  onet reference: {share:.5f} of coordinates within 1e-4, "
          f"max {float(err.max()):.3e} (bound {2 * LR * (SMALL_ITERS + 1):g})")
    if share < 0.999 or float(err.max()) > 2 * LR * (SMALL_ITERS + 1):
        fail("small ONet-Opt run disagrees with the CPU run")


def seeded_victim(name: str, dev, clouds: torch.Tensor, seed: int = 0):
    """A victim at its published widths from the port's own seeded init,
    its batch-norm statistics calibrated on `clouds` and perturbed
    (`models.common.calibrate_batch_norm`), on `dev` in eval mode."""
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.models.common import calibrate_batch_norm

    torch.manual_seed(seed)
    return calibrate_batch_norm(build_model(name).to(dev), clouds.to(dev),
                                seed)


def victim_clouds(gen, n: int) -> torch.Tensor:
    """n of phase 7's ellipsoid clouds (1024 points, 8 outliers each)
    normalised to the unit sphere, as the victims see defended clouds."""
    from if_defense_tpu_torch.ops import normalize_unit_sphere

    return normalize_unit_sphere(torch.from_numpy(ellipsoids(gen, n)))


def check_small_victims(dev) -> None:
    """Each victim on a small batch (B=4, N=1024), CUDA (B5/B6 kernels, TF32
    off) against the port's CPU path (the plain versions), same weights,
    unmasked and masked (~90 % valid, the last cloud's first 100 points
    invalid): logits within atol VICTIM_TOL of the largest magnitude and
    rtol VICTIM_TOL (f32 sums in other orders; DGCNN's and PointConv's
    kNN graphs come from distance matmuls whose rounding differs, and can
    flip a near tie at the k-th neighbour)."""
    from if_defense_tpu_torch.models import build_model

    pc = victim_clouds(np.random.default_rng(12), 4)
    mask = torch.from_numpy(np.random.default_rng(13).uniform(
        size=(4, 1024)) > 0.1)
    mask[-1, :100] = False
    for name in VICTIMS:
        cpu = seeded_victim(name, "cpu", pc)
        card = build_model(name).to(dev).eval()
        card.load_state_dict(cpu.state_dict())
        for tag, m in (("unmasked", None), ("masked", mask)):
            with torch.no_grad():
                want, _ = cpu(pc, m)
                got, _ = card(pc.to(dev), None if m is None else m.to(dev))
            compare(f"{name} {tag} logits", got.cpu(), want,
                    VICTIM_TOL * float(want.abs().max()), VICTIM_TOL)


def run_inference(dev, tmp: str) -> tuple[dict, dict]:
    """`cli/inference.py` at full width for each victim: 64 clouds of 1024
    points (phase 7's ellipsoids in the unit sphere, 40 classes, a target
    label), batch 32, weights from `seeded_victim` saved through
    `params_to_jax` as the flat npz the CLI reads. Normal mode first, with
    the B5/B6 launch counters set to 0 just before and read just after,
    then target mode (warm: the CLI keeps the loaded victim). -> (clouds/s
    per victim and mode, host clock around main(); launches per victim)."""
    from if_defense_tpu_torch.cli import inference
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import params_to_jax

    clouds = victim_clouds(np.random.default_rng(14), VICTIM_CLOUDS)
    label = np.arange(VICTIM_CLOUDS) % 40
    data = save_npz(os.path.join(tmp, "victims.npz"), {
        "test_pc": clouds.numpy(), "test_label": label,
        "target_label": (label + 7) % 40})
    counters = (cuda_fps.launches, cuda_ballquery.launches)
    rates, launches = {}, {}
    for name in VICTIMS:
        model = seeded_victim(name, dev, clouds[:VICTIM_B])
        ckpt = save_eval_checkpoint(os.path.join(tmp, f"{name}.npz"),
                                    params_to_jax(model.state_dict(), model),
                                    {"model": name})
        del model
        argv = ["--data", data, "--checkpoint", ckpt, "--batch_size",
                str(VICTIM_B), "--device", "cuda"]
        for mode in ("normal", "target"):
            if mode == "normal":
                for counter in counters:
                    for k in counter:
                        counter[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inference.main(argv + ["--mode", mode])
            torch.cuda.synchronize()
            rates[f"{name} {mode}"] = VICTIM_CLOUDS / (
                time.perf_counter() - t0)
            if mode == "normal":
                launches[name] = {k: v for c in counters
                                  for k, v in c.items()}
            if (out["n"] != VICTIM_CLOUDS or out["model"] != name
                    or not 0 <= out["accuracy"] <= 1
                    or (mode == "target"
                        and not 0 <= out["target_success"] <= 1)):
                fail(f"inference {name} {mode}: {out}")
        hold_inference(dev, data, ckpt, name, out)
        want = dict(zip(("fps", "ballquery"), VICTIM_LAUNCHES[name]))
        print(f"  {name}: accuracy {out['accuracy']:.4f}, target success "
              f"{out['target_success']:.4f}, {rates[f'{name} normal']:.1f} / "
              f"{rates[f'{name} target']:.1f} clouds/s (first / warm), "
              f"launches {launches[name]} (want {want})")
        if launches[name] != want:
            fail(f"B5/B6 launches {launches[name]} in {name}'s "
                 f"{VICTIM_CLOUDS}-cloud pass, not {want}")
    return rates, launches


class KnnTap:
    """Stands in for `ops.knn_points` in the victims that group by kNN
    (models/dgcnn.py, models/pointconv.py), on one forward at a time. With
    no graphs given it records each call's k + 1 nearest (indices and
    distances) and the scale of their rounding; given the graphs that a
    recording kept, it returns them in place of its own, which it keeps in
    `own`."""

    def __init__(self, graphs: list | None = None):
        self.graphs, self.own = graphs, []
        self.log = []

    def __call__(self, k, xyz, query=None, candidate_mask=None):
        from if_defense_tpu_torch.ops import knn_points

        q = xyz if query is None else query
        if self.graphs is None:
            idx, d = knn_points(k + 1, xyz, q, return_dist=True,
                                candidate_mask=candidate_mask)
            scale = (q * q).sum(-1) + (xyz * xyz).sum(-1).amax(
                -1, keepdim=True)
            self.log.append((idx, d, scale))
            return idx[..., :k]
        self.own.append(knn_points(k, xyz, q, candidate_mask=candidate_mask)
                        .cpu())
        return self.graphs[len(self.own) - 1][0][..., :k].to(xyz.device)

    def __enter__(self):
        from if_defense_tpu_torch.models import dgcnn, pointconv

        self.saved = dgcnn.knn_points
        dgcnn.knn_points = pointconv.knn_points = self
        return self

    def __exit__(self, *exc):
        from if_defense_tpu_torch.models import dgcnn, pointconv

        dgcnn.knn_points = pointconv.knn_points = self.saved


class SplitKnnTap(KnnTap):
    """A `KnnTap` replay for a split forward: each shard's c-th kNN call
    (the shard read from `parallel.current_exchange()`) gets its rows of
    the c-th graph that a one-shard recording kept. `changed` counts the
    rows whose own graph (as a set) differs from the replayed one."""

    def __init__(self, graphs: list, sizes: list):
        super().__init__(graphs)
        self.starts = [sum(sizes[:i]) for i in range(len(sizes))]
        self.sizes, self.calls = sizes, [0] * len(sizes)
        self.changed = 0

    def __call__(self, k, xyz, query=None, candidate_mask=None):
        from if_defense_tpu_torch.ops import knn_points
        from if_defense_tpu_torch.parallel import current_exchange

        i = current_exchange()[1]
        c, self.calls[i] = self.calls[i], self.calls[i] + 1
        rows = slice(self.starts[i], self.starts[i] + self.sizes[i])
        want = self.graphs[c][0][rows, ..., :k].to(xyz.device)
        own = knn_points(k, xyz, xyz if query is None else query,
                         candidate_mask=candidate_mask)
        differs = (own.sort(-1).values != want.sort(-1).values).any(-1)
        self.changed += int(differs.sum())       # one shard a thread
        return want


def regraphed(cpu: list, card: list) -> torch.Tensor:
    """Clouds whose kNN graph on the card (each call on the replayed
    graph's inputs) differs from the CPU's; fails unless each differing
    row is a near tie by the CPU's distances: its (k+1)-th nearest within
    KNN_TIE of the k-th, and every CPU neighbour the card left out within
    it too. -> [B] bool."""
    out = None
    for (idx, d, scale), own in zip(cpu, card):
        k = own.shape[-1]
        rows = (idx[..., :k].sort(-1).values != own.sort(-1).values).any(-1)
        tol = KNN_TIE * scale
        left_out = ~(idx[..., :k, None] == own[..., None, :]).any(-1)
        tie = (d[..., k] - d[..., k - 1] <= tol) & (
            ~left_out | (d[..., :k] >= (d[..., k - 1] - tol)[..., None])
        ).all(-1)
        if bool((rows & ~tie).any()):
            fail(f"kNN on the card chose other neighbours than on the CPU "
                 f"in {int((rows & ~tie).sum())} rows that are no near tie")
        out = rows.any(-1) if out is None else out | rows.any(-1)
    return out


def hold_inference(dev, data: str, ckpt: str, name: str, got: dict) -> None:
    """The card's target-mode run of `cli/inference.py` (`got`) against the
    port's CPU path on the same npz and checkpoint, through the CLI's loader
    (`load_eval_model`) and batches (`ModelNet40Attack`, batch VICTIM_B, the
    last padded). A kNN graph's rows can flip at a near tie between the
    card's and the CPU's rounding, so the card first runs each batch on
    the CPU's graphs (`KnnTap`): every cloud's logits within
    `check_small_victims`' tolerance, and its own graphs equal to the CPU's
    but at near ties (`regraphed`). Then on its own graphs: predictions
    equal to the CPU's but for clouds whose graph differs or whose two best
    CPU logits lie within 2 atol of each other, and the CLI's counts of
    correct and targeted clouds equal the CPU's but for the clouds whose
    predictions differ."""
    from if_defense_tpu_torch.cli.inference import load_eval_model
    from if_defense_tpu_torch.data import ModelNet40Attack, batch_iterator
    from if_defense_tpu_torch.training import make_eval_step

    cpu_step = make_eval_step(load_eval_model(ckpt)[0])
    card_step = make_eval_step(load_eval_model(ckpt)[0].to(dev))
    want, replayed, logits, moved, label, target = [], [], [], [], [], []
    t0 = time.perf_counter()
    for batch, valid in batch_iterator(ModelNet40Attack(data, 1024, False),
                                       VICTIM_B, pad_last=True):
        pc = torch.from_numpy(batch[0].astype(np.float32))
        with KnnTap() as cpu:
            want.append(cpu_step(pc)[:valid])
        with KnnTap(cpu.log) as card:
            replayed.append(card_step(pc.to(dev)).cpu()[:valid])
        moved.append(regraphed(cpu.log, card.own)[:valid] if cpu.log
                     else torch.zeros(valid, dtype=torch.bool))
        logits.append(card_step(pc.to(dev)).cpu()[:valid])
        label.append(torch.from_numpy(batch[1][:valid]).long())
        target.append(torch.from_numpy(batch[2][:valid]).long())
    want, replayed, logits = (torch.cat(x) for x in (want, replayed, logits))
    moved, label, target = (torch.cat(x) for x in (moved, label, target))
    atol = VICTIM_TOL * float(want.abs().max())
    compare(f"{name}, the CLI's {len(want)} clouds at batch {VICTIM_B}, "
            "card on the CPU's kNN graphs vs CPU, logits", replayed, want,
            atol, VICTIM_TOL)
    top2 = want.topk(2, -1).values
    near = top2[:, 0] - top2[:, 1] <= 2 * atol
    pred = want.argmax(-1)
    flips = pred != logits.argmax(-1)
    counts = {k: (round(got[key] * got["n"]), int((pred == cls).sum()))
              for k, key, cls in (("correct", "accuracy", label),
                                  ("targeted", "target_success", target))}
    print(f"  {name}: CLI n {got['n']}, (card CLI, CPU) counts {counts}; "
          f"{int(moved.sum())} clouds' kNN graphs differ at near ties; "
          f"{int(flips.sum())} predictions differ, {int(near.sum())} clouds "
          f"within 2 atol of a tie; CPU path "
          f"{time.perf_counter() - t0:.1f} s")
    if got["n"] != len(want) or bool((flips & ~near & ~moved).any()) or any(
            abs(c - r) > int(flips.sum()) for c, r in counts.values()):
        fail(f"inference {name} on the card disagrees with the CPU path")


def profile_victims(dev) -> dict:
    """torch.profiler over one warm batch (B=32, N=1024) of PointNet++ and
    of DGCNN: wall ms, device ms, busy share, B5 + B6's share and the
    device operations that take the most time. -> {victim: numbers}."""
    from torch.profiler import ProfilerActivity, profile

    x = victim_clouds(np.random.default_rng(15), VICTIM_B).to(dev)
    out = {}
    for name in ("pointnet2", "dgcnn"):
        model = seeded_victim(name, dev, x)
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        if not events:
            print(f"  {name}: wall {wall:.3f} ms; device time not measured "
                  "(the profiler saw no CUDA kernel)")
            continue
        busy = sum(e.self_device_time_total for e in events) / 1e3
        ours = sum(e.self_device_time_total for e in events
                   if "fps_kernel" in e.key or "ballquery_kernel" in e.key
                   ) / 1e3
        out[name] = dict(wall_ms=wall, device_ms=busy, busy=busy / wall,
                         b5_b6_ms=ours, operations=sum(e.count
                                                       for e in events))
        print(f"  {name}, one batch of {VICTIM_B}: wall {wall:.3f} ms, "
              f"device {busy:.3f} ms (busy share {busy / wall:.3f}, "
              f"{out[name]['operations']} device operations), B5 + B6 "
              f"{ours:.4f} ms ({ours / busy:.4f} of device time)")
        print_top(events, 8)
    return out


def check_repulsion_any_k(dev) -> None:
    """B1-B3 above k = 8, where the kernels scan for each row's k-th
    smallest distance: k = 9, 16 and 33 at B = 4 and 48, N = 1024, on
    random points with duplicates (B3 at points moved by ~1e-3) and on the
    16x8x8 lattice, f32 and bf16, against their plain versions with
    `check_repulsion`'s tolerances (B2 bit-equal). Then device times at
    B = 48 (B1 forward + backward, B2 f32), k = 5 beside them."""
    from if_defense_tpu_torch.ops import cuda_repulsion

    gen = np.random.default_rng(16)
    for b in (4, B):
        pts = gen.uniform(-0.45, 0.45, (b, N, 3)).astype(np.float32)
        pts[:, N - 24:] = pts[:, :24]
        pts = torch.from_numpy(pts).to(dev)
        moved = pts + torch.from_numpy(gen.normal(
            scale=1e-3, size=pts.shape).astype(np.float32)).to(dev)
        lat = torch.from_numpy(lattice(gen, b, (16, 8, 8))).to(dev)
        w = torch.from_numpy(gen.uniform(0.5, 1.5, b).astype(
            np.float32)).to(dev)
        for k in REPULSION_KS:
            check_repulsion(f"random B={b} k={k}", pts, moved, w, k)
            check_repulsion(f"lattice B={b} k={k}", lat, lat, w, k)
    def timed(fn, names) -> str:
        got = device_ms(fn, names)       # graph replay where the profiler
        return (f"{got[0]:.4f} ms (profiler)" if got     # saw no kernel
                else f"{graph_ms(fn):.4f} ms (graph replay)")

    for k in (5,) + REPULSION_KS:
        loss = timed(lambda: bare_grad(cuda_repulsion.repulsion_loss_cuda,
                                       pts, w, k),
                     ("rep_fwd", "rows_to_loss", "rep_bwd"))
        mask = timed(lambda: cuda_repulsion.repulsion_mask_cuda(pts, k),
                     ("rep_mask",))
        print(f"  k={k}, B={B}, N={N}, f32, device time a call: B1 fwd + "
              f"bwd {loss}, B2 {mask}")


def attack_draws(gen: torch.Generator, b: int, n: int) -> dict:
    """The random draws of phase 13 (a)'s attacks, made once on the CPU
    from `gen` so that the card and the CPU start from the same ones."""
    def normal(*shape):
        return torch.randn(shape, generator=gen)

    def uniform(*shape):
        return torch.rand(shape, generator=gen)

    return {"perturb": normal(2, b, n, 3), "add": normal(1, b, 32, 3),
            "add_cluster": normal(1, b, 96, 3),
            "add_object": (normal(1, b, 3, 64, 3), normal(1, b, 3, 3),
                           uniform(1, b, 3, 3)),
            "knn": normal(b, n, 3), "ifgm": normal(b, n, 3),
            "mifgm": normal(b, n, 3), "pgd": (uniform(b, n, 3),
                                              normal(b, n, 3))}


def attack_calls(logits_fn, pc, normal, target, draws) -> dict:
    """{family: call -> (adv, success)} of every attack of the library at
    phase 13 (a)'s few iterations, on one device's tensors and draws."""
    import importlib

    from if_defense_tpu_torch.attack import (
        chamfer_dist,
        chamfer_knn_dist,
        cw_add,
        cw_add_cluster,
        cw_add_object,
        cw_knn,
        cw_perturb,
    )

    fgm = importlib.import_module("if_defense_tpu_torch.attack.fgm")
    it = ATTACK_SMALL_ITERS
    budget = 0.08 * np.sqrt(pc.shape[1] * 3)

    def cw(fn, *args, **kw):
        return lambda: fn(logits_fn, pc, target, None, *args,
                          num_iter=it, **kw)[1:]

    return {
        "perturb": cw(cw_perturb, binary_step=2, draws=draws["perturb"]),
        "add": cw(cw_add, chamfer_dist, num_add=32, binary_step=1,
                  draws=draws["add"]),
        "add_cluster": cw(cw_add_cluster, binary_step=1,
                          draws=draws["add_cluster"]),
        "add_object": cw(cw_add_object, binary_step=1,
                         draws=draws["add_object"]),
        "knn": lambda: cw_knn(logits_fn, pc, target, None, chamfer_knn_dist,
                              normal=normal, num_iter=it,
                              draws=draws["knn"]),
        "fgm": lambda: fgm.fgm(logits_fn, pc, target, budget),
        **{name: (lambda name=name: getattr(fgm, name)(
            logits_fn, pc, target, budget, budget / it, it,
            draws=draws[name])) for name in ("ifgm", "mifgm", "pgd")},
    }


def target_margins(logits: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """logits[cls] minus the best other logit, per row."""
    own = logits.gather(-1, cls[:, None])[:, 0]
    return own - logits.scatter(-1, cls[:, None], -torch.inf).amax(-1)


def input_grads(fn, pc: torch.Tensor, cls: torch.Tensor, loss: str):
    """The gradient to the clouds of the margin loss toward `cls` (every
    targeted attack's adversarial term) or of the cross entropy toward it
    (Drop's saliency, the adding attacks' critical points)."""
    from if_defense_tpu_torch.attack.losses import (
        cross_entropy_adv_loss,
        logits_adv_loss,
    )

    x = pc.detach().requires_grad_(True)
    adv = logits_adv_loss if loss == "margin" else cross_entropy_adv_loss
    return torch.autograd.grad(adv(fn(x), cls).sum(), x)[0]


def check_small_attacks(dev) -> None:
    """Every attack family of the library for a few iterations on PointNet++
    and PointNet (B = 4 clouds of 1024 points, seeded weights calibrated on
    32 clouds), and Drop masked on PointNet++ (20 points in 4 rounds), on
    the card against the port's CPU path with the same weights and draws.

    First each victim's backward on the same clouds: the gradients of the
    margin loss toward the target and of the cross entropy toward the label
    agree in direction, cosine >= GRAD_COS a cloud. Then every run gives
    finite clouds of the CPU run's shape, and the runs in ATTACK_BOUND are
    held to phase 3's bound: >= 99.9 % of the adversarial coordinates (of
    Drop, of the keep mask) within 1e-4, with success masks equal but where
    a cloud's margin of the target (Drop: of the label) is a near tie on
    either output, within VICTIM_TOL of the largest logit. The other runs
    print the same numbers: a max-pool whose two best entries lie within
    rounding of each other sends a gradient to another point on the card
    than on the CPU, and the attacks' steps (Adam's first ones move every
    coordinate by about lr, FGM's by up to the budget) carry the difference
    on, so that their trajectories part. PointNet++ pools groups of 32 and
    64 points around 640 centres a cloud, so such near ties come up on
    every forward; an adding attack starts its points 1e-7 from clean
    points, which the victim's pools then tie with. Deterministic
    algorithms on, as in the CLI, so that the card's runs repeat.
    """
    from if_defense_tpu_torch.attack.drop import saliency_drop_masked
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.ops import normalize_unit_sphere

    pts, nrm = ellipsoids_and_normals(np.random.default_rng(17), VICTIM_B)
    calib = normalize_unit_sphere(torch.from_numpy(pts))
    b = ATTACK_SMALL_B
    pc, normal = calib[:b].contiguous(), torch.from_numpy(nrm[:b])
    label = torch.arange(b) % 40
    target = (label + 7) % 40
    draws = attack_draws(torch.Generator().manual_seed(18), b, 1024)

    def on(x, d):
        if isinstance(x, dict):
            return {k: on(v, d) for k, v in x.items()}
        return tuple(on(y, d) for y in x) if isinstance(x, tuple) else x.to(d)

    for name in ("pointnet2", "pointnet"):
        cpu = seeded_victim(name, "cpu", calib)
        card = build_model(name).to(dev).eval()
        card.load_state_dict(cpu.state_dict())
        for m in (cpu, card):
            for p in m.parameters():
                p.requires_grad_(False)
        fns = {d: (lambda x, m=m: m(x)[0], lambda x, k, m=m: m(x, k)[0])
               for d, m in (("cpu", cpu), (dev, card))}
        for loss, cls in (("margin", target), ("cross entropy", label)):
            want = input_grads(fns["cpu"][0], pc, cls, loss)
            got = input_grads(fns[dev][0], pc.to(dev), cls.to(dev),
                              loss).cpu()
            cos = (got * want).sum((1, 2)) / (
                got.norm(dim=(1, 2)) * want.norm(dim=(1, 2)))
            print(f"  {name} input gradient of the {loss}: cosine "
                  f"{float(cos.min()):.7f} (worst cloud), max abs err "
                  f"{float((got - want).abs().max()):.3e} of "
                  f"{float(want.abs().max()):.3e}")
            if float(cos.min()) < GRAD_COS:
                fail(f"{name}'s {loss} gradient on the card disagrees with "
                     "the CPU's")
        want = attack_calls(fns["cpu"][0], pc, normal, target, draws)
        got = attack_calls(fns[dev][0], pc.to(dev), normal.to(dev),
                           target.to(dev), on(draws, dev))
        runs = [(family, got[family], want[family], target)
                for family in want]
        if name == "pointnet2":
            runs.append(("drop (masked)", lambda: saliency_drop_masked(
                fns[dev][1], pc.to(dev), label.to(dev), 20)[1:],
                lambda: saliency_drop_masked(fns["cpu"][1], pc, label,
                                             20)[1:], label))
        for family, card_run, cpu_run, cls in runs:
            t0 = time.perf_counter()
            (g, g_succ), (w, w_succ) = card_run(), cpu_run()
            g, g_succ, w = g.detach().cpu(), g_succ.cpu(), w.detach()
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"{name} {family}: shape {tuple(g.shape)} vs "
                     f"{tuple(w.shape)} or non-finite values")
            err = (g - w).abs()
            share = float((err <= ATTACK_TOL).float().mean())
            flips = g_succ != w_succ
            if family.startswith("drop"):
                logits = [fns["cpu"][1](pc, k) for k in (g, w)]
            else:
                logits = [fns["cpu"][0](x) for x in (g, w)]
            tol = VICTIM_TOL * max(float(x.abs().max()) for x in logits)
            near = torch.stack([target_margins(x, cls).abs() <= tol
                                for x in logits]).any(0)
            held = (name, family) in ATTACK_BOUND
            print(f"  {name} {family}: {share:.5f} of "
                  f"{'mask entries' if family.startswith('drop') else 'coordinates'}"
                  f" within {ATTACK_TOL:g}, max {float(err.max()):.3e}; "
                  f"success card {g_succ.int().tolist()} / CPU "
                  f"{w_succ.int().tolist()}, {int(near.sum())} near ties"
                  f"{' (held)' if held else ''}; "
                  f"{time.perf_counter() - t0:.1f} s")
            if held and (share < ATTACK_SHARE or bool((flips & ~near).any())):
                fail(f"small {family} on {name}: the card disagrees with "
                     "the CPU path")


def attack_cli(argv: list[str]) -> dict:
    """One `cli/attack.py` run on the card, the B5/B6, gather-backward and
    CSR launch counters set to 0 just before and read just after. -> {out,
    rate, seconds, launches}."""
    from if_defense_tpu_torch.cli import attack
    from if_defense_tpu_torch.ops import (
        cuda_ballquery,
        cuda_csr,
        cuda_fps,
        cuda_gather,
    )

    counters = (cuda_fps.launches, cuda_ballquery.launches,
                cuda_gather.launches, cuda_csr.launches)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, rate = attack.main(argv + ["--batch_size", str(ATTACK_B),
                                    "--device", "cuda"])
    torch.cuda.synchronize()
    return dict(out=out, rate=rate, seconds=time.perf_counter() - t0,
                launches={k: v for c in counters for k, v in c.items()})


def check_attack_output(tag: str, run: dict, attack: str, data: str,
                        n: int) -> np.ndarray:
    """The output npz of one run: n clouds, finite, the attack's point
    count, labels as given, and its budget against the clean clouds as the
    CLI read them (normalised): kNN's offset a point <= --knn_budget 0.1,
    FGM's, I-FGM's and MI-FGM's global L2 <= 0.08 sqrt(3 K) (PGD's <= twice
    that: its ball is centred on its start, itself within it), the adding
    attacks' clean part unchanged. -> the adversarial clouds."""
    from if_defense_tpu_torch.data import (
        ModelNet40Attack,
        ModelNet40NormalAttack,
        load_npz,
    )

    out = load_npz(run["out"])
    adv = out.test_pc
    variant = ModelNet40NormalAttack if attack == "knn" else ModelNet40Attack
    clean = np.stack([x[0][:, :3] for x in variant(data, 1024)])
    points = ATTACK_POINTS.get(attack, 1024)
    if adv.shape != (n, points, 3) or not np.isfinite(adv).all():
        fail(f"{tag}: output {adv.shape} (want {(n, points, 3)}) or "
             "non-finite values")
    if not (np.array_equal(out.test_label, load_npz(data).test_label)
            and 0 <= run["rate"] <= 1):
        fail(f"{tag}: labels or success rate {run['rate']}")
    budget = 0.08 * np.sqrt(3 * 1024)
    if attack == "knn":
        worst, limit = np.sqrt(((adv - clean) ** 2).sum(-1)).max(), 0.1
    elif attack in ("fgm", "ifgm", "mifgm", "pgd"):
        worst = np.sqrt(((adv - clean) ** 2).sum((1, 2))).max()
        limit = budget * (2 if attack == "pgd" else 1)
    elif attack.startswith("add"):
        worst, limit = np.abs(adv[:, :1024] - clean).max(), 0.0
    else:
        worst = limit = None
    if worst is not None and worst > limit * (1 + 1e-5):
        fail(f"{tag}: {worst} beyond its budget {limit}")
    print(f"  {tag}: {adv.shape}, success {run['rate']:.4f}, "
          f"{n / run['seconds']:.2f} clouds/s ({run['seconds']:.1f} s), "
          f"launches {run['launches']}"
          + ("" if worst is None else f", budget {worst:.6f} <= {limit:.6f}"))
    return adv


def run_attacks(dev, tmp: str, keep: str | None = None) -> tuple[dict, dict]:
    """`cli/attack.py` on the card at batch 32 and 1024 points (phase 13
    (b)): perturb at PERTURB_DEPTH (5 x 100) on PointNet++, then each
    other family at reduced iterations (ATTACK_RUNS; kNN on DGCNN, with
    normals), each checked by `check_attack_output`; B5 and B6 exactly 2 x
    5 x 100 launches each in the perturb run, and the gather-backward
    kernel 5 x 5 x 100 (a backward of PointNet++ to its input: level 1's centre and
    group gathers of the input, level 2's of the level-1 centres and
    features); every other run launches it too. A --resume run stopped after one of
    two batches and completed, bit-identical to an uninterrupted one.
    `cli/inference.py` rescores the perturb output in target mode: its
    count of targeted clouds may differ from the attack's only by the
    clouds whose target margin is a near tie (VICTIM_TOL of the largest
    logit) and those the attack counts failed (their cloud is the last
    iterate). The perturb output and the PointNet++ checkpoint are copied
    into `keep` (phase 15 defends and scores them). -> (clouds/s per run,
    B5/B6 launches summed over the runs)."""
    from if_defense_tpu_torch.cli import inference
    from if_defense_tpu_torch.cli.inference import load_eval_model
    from if_defense_tpu_torch.data import load_npz, save_npz
    from if_defense_tpu_torch.ops import normalize_unit_sphere
    from if_defense_tpu_torch.training import make_eval_step
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import params_to_jax

    n2 = 2 * ATTACK_B
    pts, nrm = ellipsoids_and_normals(np.random.default_rng(19), n2)
    label = np.arange(n2) % 40
    labels = {"test_label": label, "target_label": (label + 7) % 40}
    one = {k: v[:ATTACK_B] for k, v in labels.items()}
    data = save_npz(os.path.join(tmp, "clouds.npz"),
                    {"test_pc": pts[:ATTACK_B], **one})
    two = save_npz(os.path.join(tmp, "clouds64.npz"),
                   {"test_pc": pts, **labels})
    normals = save_npz(os.path.join(tmp, "normals.npz"), {
        "test_pc": np.concatenate([pts, nrm], -1)[:ATTACK_B], **one})
    calib = normalize_unit_sphere(torch.from_numpy(pts[:ATTACK_B]))
    ckpt = {}
    for name in ("pointnet2", "dgcnn"):
        model = seeded_victim(name, dev, calib)
        ckpt[name] = save_eval_checkpoint(
            os.path.join(tmp, f"{name}.npz"),
            params_to_jax(model.state_dict(), model), {"model": name})
        del model

    def argv(attack, victim, src, out, extra):
        return ["--attack", attack, "--data", src, "--checkpoint",
                ckpt[victim], "--output", os.path.join(tmp, out), *extra]

    rates, total = {}, {"fps": 0, "ballquery": 0, "gather_backward": 0,
                        "csr": 0}
    steps, iters = PERTURB_DEPTH
    perturb = attack_cli(argv("perturb", "pointnet2", data, "perturb.npz",
                              ["--binary_step", str(steps), "--num_iter",
                               str(iters)]))
    check_attack_output(f"perturb {steps} x {iters}, PointNet++", perturb,
                        "perturb", data, ATTACK_B)
    want = 2 * steps * iters
    if perturb["launches"] != {"fps": want, "ballquery": want,
                               "gather_backward": 5 * want // 2,
                               "csr": 5 * want // 2}:
        fail(f"launches {perturb['launches']} in perturb {steps} x {iters} on "
             f"PointNet++, not {want} B5/B6 each and {5 * want // 2} "
             "gather backward, each on a CSR of its own")
    runs = {"perturb": perturb}
    for attack, victim, extra in ATTACK_RUNS:
        tag = f"{attack} {' '.join(extra)} {victim}".replace("  ", " ")
        src = normals if attack == "knn" else data
        runs[tag] = attack_cli(argv(attack, victim, src,
                                    f"{attack}-{len(runs)}.npz", extra))
        check_attack_output(tag, runs[tag], attack, src, ATTACK_B)
        if runs[tag]["launches"]["gather_backward"] <= 0:
            fail(f"{tag}: the gather-backward kernel was not launched")
        if runs[tag]["launches"]["csr"] != runs[tag]["launches"][
                "gather_backward"]:
            fail(f"{tag}: CSR builds {runs[tag]['launches']} are not one a "
                 "gather backward")
    for tag, run in runs.items():
        rates[tag] = ATTACK_B / run["seconds"]
        for k in total:
            total[k] += run["launches"][k]

    # resume: perturb 2 x 25 over two batches, stopped after the first
    flags = ["--binary_step", "2", "--num_iter", "25"]
    full = attack_cli(argv("perturb", "pointnet2", two, "full.npz", flags))
    part = argv("perturb", "pointnet2", two, "resumed.npz",
                flags + ["--resume"])
    stopped = attack_cli(part + ["--stop_after_batches", "1"])
    resumed = attack_cli(part)
    got, want_ = load_npz(resumed["out"]), load_npz(full["out"])
    same = all(np.array_equal(getattr(got, k), getattr(want_, k))
               for k in ("test_pc", "test_label", "target_label"))
    print(f"  resume: stopped {stopped['out']} after 1 batch, resumed run "
          f"{'bit-identical' if same else 'DIFFERENT'} to the uninterrupted "
          f"one (success {resumed['rate']:.4f} / {full['rate']:.4f}; "
          f"{full['seconds']:.1f} s for {n2} clouds)")
    if not same or stopped["out"] is not None or (
            resumed["rate"] != full["rate"]):
        fail("a resumed attack run differs from an uninterrupted one")
    for run in (full, stopped, resumed):
        for k in total:
            total[k] += run["launches"][k]

    # inference rescores the perturb output, target mode
    scored = inference.main(["--data", perturb["out"], "--checkpoint",
                             ckpt["pointnet2"], "--mode", "target",
                             "--batch_size", str(ATTACK_B), "--device",
                             "cuda"])
    step = make_eval_step(load_eval_model(ckpt["pointnet2"])[0].to(dev))
    adv = torch.from_numpy(load_npz(perturb["out"]).test_pc).to(dev)
    logits = step(adv)
    margin = target_margins(logits, torch.from_numpy(
        one["target_label"]).long().to(dev))
    near = int((margin.abs() <= VICTIM_TOL * float(
        logits.abs().max())).sum())
    attacked = round(perturb["rate"] * ATTACK_B)
    rescored = round(scored["target_success"] * scored["n"])
    print(f"  inference rescoring perturb: {rescored} of {scored['n']} "
          f"targeted (the attack: {attacked}); {near} near ties, "
          f"{ATTACK_B - attacked} failed clouds")
    if scored["n"] != ATTACK_B or abs(rescored - attacked) > (
            near + ATTACK_B - attacked):
        fail("cli/inference.py's targeted count of the perturb output "
             "differs from the attack's beyond its near ties")
    if keep:
        shutil.copy(perturb["out"], os.path.join(keep, "perturb.npz"))
        for suffix in ("", ".meta.json"):
            shutil.copy(ckpt["pointnet2"] + suffix,
                        os.path.join(keep, "pointnet2.npz" + suffix))
    return rates, total


def check_attacks(dev, keep: str | None = None) -> tuple[dict, dict, dict]:
    """Phase 13: (a) `check_small_attacks`, (b) `run_attacks`, then a
    profile of one warm CW iteration on PointNet++ at batch 32, with and
    without deterministic algorithms. -> (clouds/s, B5/B6 launches of
    (b), the profile)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        check_small_attacks(dev)
    finally:
        torch.use_deterministic_algorithms(before)
    with tempfile.TemporaryDirectory() as tmp:
        rates, launches = run_attacks(dev, tmp, keep)
    print("  a CW iteration on PointNet++, profiled "
          "(tools/profile_cw_iteration.py):")
    return rates, launches, tool("profile_cw_iteration").profile(dev)


def train_draw(gen: torch.Generator, masks: list):
    """A dropout draw from `gen` that keeps each mask it draws in `masks`."""
    from if_defense_tpu_torch.models.common import generator_draw

    draw = generator_draw(gen)

    def record(shape, rate):
        masks.append(draw(shape, rate))
        return masks[-1]

    return record


def step_differs(cpu, card) -> tuple[str | None, float, float]:
    """A train step on the card (`card`, after backward) against the same
    step on the CPU (`cpu`; in phase 18 the one-shard step on the card):
    (what is out of phase 14 (a)'s bounds or None,
    the least gradient cosine, the largest batch-statistics error of its
    scale). Gradients: the
    biases that feed a batch norm (`batch_norm_fed_biases`: 0 but for
    rounding) below 1e-3 of the largest gradient entry on both; a tensor
    whose CPU gradient lies below 1e-4 of it within that of the CPU's;
    every other tensor at cosine >= GRAD_COS. Batch statistics within
    TRAIN_STATS_TOL of their scale: a variance's largest entry; a mean's
    largest entry or the root of its variance's, the larger (the victims'
    first norms see centred clouds, whose means are 0 but for rounding)."""
    from if_defense_tpu_torch.models.common import batch_norm_fed_biases

    grads = {n: p.grad.cpu().double() for n, p in cpu.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    least, worst = 1.0, 0.0
    zero = batch_norm_fed_biases(cpu)
    for n, p in card.named_parameters():
        g, w = p.grad.cpu().double(), grads[n]
        if n in zero:
            if max(float(g.abs().max()), float(w.abs().max())) > 1e-3 * top:
                return f"gradient of {n}, 0 but for rounding, is not", 0, 0
        elif float(w.abs().max()) < 1e-4 * top:
            if float((g - w).abs().max()) > 1e-4 * top:
                return (f"gradient of {n} (below 1e-4 of the largest)",
                        0, 0)
        else:
            cos = float((g * w).sum() / (g.norm() * w.norm()))
            least = min(least, cos)
            if not cos >= GRAD_COS:
                return (f"gradient of {n} at cosine {cos:.6f} to the "
                        "CPU's", least, 0)
    stats = {n: b.cpu() for n, b in cpu.named_buffers()}
    for n, g in card.named_buffers():
        w = stats[n]
        scale = float(w.abs().max())
        if n.endswith(".mean"):
            scale = max(scale, float(stats[n[:-4] + "var"].max()) ** 0.5)
        err = float((g.cpu() - w).abs().max()) / scale
        worst = max(worst, err)
        if err > TRAIN_STATS_TOL:
            return (f"batch statistics {n} {err:.2e} of their scale off",
                    least, worst)
    return None, least, worst


def check_small_victim_training(dev) -> None:
    """Phase 14 (a): each victim (and PointNet with the feature transform)
    for TRAIN_SMALL_STEPS train steps at B=4, N=1024 on the card and on the
    port's CPU path, from the same `flax_init_params(0)` values, batches
    and dropout masks (drawn on the CPU, fed to both through the `draw`
    seam); DGCNN and PointConv replay the CPU's kNN graphs on the card
    (`KnnTap`). Each step starts from the CPU's state (weights, batch
    statistics, Adam's moments and count): max-pool near ties send a
    gradient to another point on the card (PERF.md section 6) and
    Adam's normalised step moves a weight by the rate for a gradient near
    0 either way, so trajectories are held step by step, in direction and
    not in bits. Each step: loss rtol TRAIN_LOSS_RTOL; gradients and batch
    statistics as `step_differs` holds them."""
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    b, steps = TRAIN_SMALL_B, TRAIN_SMALL_STEPS
    pc = victim_clouds(np.random.default_rng(16), b * steps)
    label = torch.from_numpy(np.random.default_rng(17).integers(
        0, 40, b * steps))
    for name, kw in TRAIN_VICTIMS:
        tag = name + (" (feature transform)" if kw else "")
        weights = params_from_jax(flax_init_params(0, name, **kw),
                                  build_model(name, **kw))
        cpu, card = (create_train_state(
            build_model(name, **kw).to(where), total_epochs=1,
            steps_per_epoch=steps) for where in ("cpu", dev))
        for state in (cpu, card):
            state.model.load_state_dict(weights)
        fea = 0.001 if kw else 0.0
        cpu_step = make_train_step(cpu.model, False, fea)
        card_step = make_train_step(card.model, False, fea)
        gen = torch.Generator().manual_seed(18)
        worst = dict(loss=0.0, cos=1.0, stats=0.0)
        for i in range(steps):
            if i:
                card.model.load_state_dict(cpu.model.state_dict())
                card.optimizer.load_state_dict(cpu.optimizer.state_dict())
                card.set_step(cpu.step)
            x, y = pc[i * b:(i + 1) * b], label[i * b:(i + 1) * b]
            masks = []
            with KnnTap() as tap:
                _, want = cpu_step(cpu, x, y, train_draw(gen, masks))
            replay = iter(masks)
            with KnnTap(tap.log):
                _, got = card_step(card, x.to(dev), y.to(dev),
                                   lambda shape, rate: next(replay))
            loss = abs(float(got["loss"]) - float(want["loss"])) / abs(
                float(want["loss"]))
            worst["loss"] = max(worst["loss"], loss)
            if loss > TRAIN_LOSS_RTOL:
                fail(f"{tag} step {i + 1}: loss {float(got['loss'])} on the "
                     f"card, {float(want['loss'])} on the CPU")
            err, cos, stats = step_differs(cpu.model, card.model)
            if err:
                fail(f"{tag} step {i + 1}: {err}")
            worst["cos"] = min(worst["cos"], cos)
            worst["stats"] = max(worst["stats"], stats)
        print(f"  {tag}: {steps} steps, loss rel {worst['loss']:.2e}, "
              f"gradient cosine >= {worst['cos']:.7f}, batch statistics "
              f"{worst['stats']:.2e} of their scale")


def train_cli(argv: list[str], hybrid: bool = False) -> dict:
    """One `cli/train.py` (or `cli/hybrid_train.py`) run on the card with
    the B5/B6, gather-backward and CSR launch counters set to 0 just
    before and read just after. -> {seconds (host clock around main()),
    launches, records}."""
    from if_defense_tpu_torch.cli import hybrid_train, train
    from if_defense_tpu_torch.ops import (
        cuda_ballquery,
        cuda_csr,
        cuda_fps,
        cuda_gather,
    )

    counters = (cuda_fps.launches, cuda_ballquery.launches,
                cuda_gather.launches, cuda_csr.launches)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (hybrid_train if hybrid else train).main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = argv[argv.index("--output") + 1]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return dict(seconds=seconds, records=records,
                launches={k: v for c in counters for k, v in c.items()})


def train_data(tmp: str) -> tuple[str, str]:
    """The classification npz (`tools/synthetic_dataset.py`, hard family:
    8 classes, 40 train and 10 test clouds each of 1024 points, unit
    sphere) and a defended-schema copy of it (every cloud's points moved
    by N(0, 0.01^2) noise) for hybrid training. -> (data, defended)."""
    data = os.path.join(tmp, "synth.npz")
    tool("synthetic_dataset").make_classification_npz(
        data, TRAIN_PER_CLASS[0], TRAIN_PER_CLASS[1], 1024, seed=0,
        family="hard")
    with np.load(data) as d:
        arrays = {k: d[k] for k in d.files}
    rng = np.random.default_rng(19)
    for key in ("train_pc", "test_pc"):
        arrays[key] = arrays[key].copy()
        arrays[key][..., :3] += 0.01 * rng.normal(
            size=arrays[key][..., :3].shape).astype(np.float32)
    defended = os.path.join(tmp, "synth_def.npz")
    np.savez(defended, **arrays)
    return data, defended


def near_ties(dev, model, data: str) -> int:
    """The test clouds of `data` whose two best classes lie within
    VICTIM_TOL of the largest logit magnitude of their batch (batches of
    TRAIN_B, as `cli/inference.py` scores them)."""
    from if_defense_tpu_torch.data import ModelNet40, batch_iterator
    from if_defense_tpu_torch.training import make_eval_step

    step = make_eval_step(model.to(dev))
    near = 0
    for (pc, _), valid in batch_iterator(
            ModelNet40(data, 1024, partition="test"), TRAIN_B,
            pad_last=True):
        logits = step(torch.from_numpy(pc).to(dev)).cpu()[:valid]
        top2 = logits.topk(2, -1).values
        near += int((top2[:, 0] - top2[:, 1] <= VICTIM_TOL * float(
            logits.abs().max())).sum())
    return near


def same_final(what: str, first: str, second: str) -> None:
    """Fail unless two train CLI runs' `final.npz` and its optimiser
    sidecar hold the same arrays, bit for bit."""
    gap, same = 0.0, True
    for name in ("final.npz", "final.npz.opt.npz"):
        with np.load(os.path.join(first, name)) as a, np.load(
                os.path.join(second, name)) as b:
            same &= a.files == b.files and all(
                a[k].tobytes() == b[k].tobytes() for k in a.files)
            gap = max([gap] + [float(np.abs(a[k].astype(np.float64)
                                            - b[k]).max())
                               for k in a.files if a[k].size
                               and a[k].shape == b[k].shape])
    print(f"    two seeded runs of {what}: final.npz and its optimiser "
          f"sidecar bit-equal {same}, largest gap {gap:.3e}")
    if not same:
        fail(f"two seeded runs of {what} differ (largest gap {gap:.3e})")


def run_train_clis(dev, tmp: str) -> tuple[dict, dict]:
    """Phase 14 (b); see the module docstring. -> (steps/s per run and
    epoch, B5/B6 and gather-backward launches summed over the runs)."""
    from if_defense_tpu_torch.cli import inference, train
    from if_defense_tpu_torch.cli.inference import load_eval_model
    from if_defense_tpu_torch.utils.checkpoint import load_metadata
    from if_defense_tpu_torch.utils.params_io import (
        adam_state_to_jax,
        flatten_params,
        load_params_npz,
    )

    data, defended = train_data(tmp)
    with np.load(data) as d:
        n_train, n_test = len(d["train_label"]), len(d["test_label"])
    steps = n_train // TRAIN_B                     # drop_last
    evals = -(-n_test // TRAIN_B)                  # the last padded
    rates, total = {}, {"fps": 0, "ballquery": 0, "gather_backward": 0,
                        "csr": 0}

    def forwards_want(name: str, forwards: int, train_steps: int) -> dict:
        per = TRAIN_FORWARD_LAUNCHES[name]
        gathers = train_steps * TRAIN_BACKWARD_LAUNCHES[name]
        return {"fps": forwards * per[0], "ballquery": forwards * per[1],
                "gather_backward": gathers, "csr": gathers}

    def check_run(tag: str, run: dict, want: dict) -> None:
        print(f"  {tag}: {run['seconds']:.1f} s, launches "
              f"{run['launches']} (want {want})")
        if run["launches"] != want:
            fail(f"B5/B6 and gather-backward launches {run['launches']} "
                 f"in {tag}, not {want}")
        for k in total:
            total[k] += run["launches"][k]
        for r in run["records"]:
            if "train_loss" in r and not np.isfinite(r["train_loss"]):
                fail(f"{tag}: train loss {r['train_loss']}")

    registry = os.path.join(tmp, "registry.json")
    best = {}
    for name, kw in TRAIN_VICTIMS:
        tag = name + ("_ft" if kw else "")
        out = os.path.join(tmp, tag)
        argv = ["--data", data, "--model", name, "--batch_size",
                str(TRAIN_B), "--epochs", str(TRAIN_EPOCHS),
                "--eval_every", "1", "--output", out,
                "--registry", registry if not kw else registry + ".ft"]
        extra = ["--feature_transform"] if kw else []
        run = train_cli(argv + extra)
        want = forwards_want(name, TRAIN_EPOCHS * (steps + evals),
                             TRAIN_EPOCHS * steps)
        check_run(f"cli/train.py {tag}", run, want)
        again = os.path.join(tmp, tag + "-again")
        argv[argv.index(out)] = again
        argv[argv.index("--registry") + 1] = os.path.join(tmp, "again.json")
        check_run(f"cli/train.py {tag}, again", train_cli(argv + extra),
                  want)
        same_final(f"cli/train.py {tag}", out, again)
        epochs = [r for r in run["records"] if "epoch" in r]
        if [r["epoch"] for r in epochs] != list(range(1, TRAIN_EPOCHS + 1)):
            fail(f"{tag}: epochs {[r['epoch'] for r in epochs]}")
        rates[tag] = [steps / r["epoch_time"] for r in epochs]
        final = run["records"][-1]
        if not kw:
            best[name] = epochs[final["best_epoch"] - 1]["test_acc"]
        print(f"    test_acc {[r['test_acc'] for r in epochs]}, train_loss "
              f"{[round(r['train_loss'], 4) for r in epochs]}, steps/s by "
              f"epoch {[round(x, 2) for x in rates[tag]]}")

    # the registry's best checkpoints score the test split as recorded
    for name in VICTIMS:
        out = inference.main(["--data", data, "--checkpoint",
                              "registry:synth", "--model", name,
                              "--registry", registry, "--normalize",
                              "--batch_size", str(TRAIN_B), "--device",
                              "cuda"])
        near = near_ties(dev, load_eval_model(
            "registry:synth", name, 1024, registry)[0], data)
        differ = round(abs(out["accuracy"] - best[name]) * out["n"])
        print(f"  cli/inference.py {name} (registry:synth): accuracy "
              f"{out['accuracy']:.4f}, the run's {best[name]:.4f}; "
              f"{near} clouds within {VICTIM_TOL:g} of a tie")
        if out["n"] != n_test or differ > near:
            fail(f"scoring {name}'s best checkpoint: {out}, the run recorded "
                 f"{best[name]}")

    # hybrid training: best by defended accuracy; twice from one seed
    hybrid_want = forwards_want("pointnet2",
                                TRAIN_EPOCHS * (2 * steps + 2 * evals),
                                TRAIN_EPOCHS * 2 * steps)
    for tag in ("hybrid-again", "hybrid"):
        out = os.path.join(tmp, tag)
        run = train_cli(["--data", data, "--def_data", defended, "--model",
                         "pointnet2", "--batch_size", str(TRAIN_B),
                         "--epochs", str(TRAIN_EPOCHS),
                         "--eval_every", "1", "--output", out, "--registry",
                         registry + "." + tag], hybrid=True)
        check_run(f"cli/hybrid_train.py pointnet2 ({tag})", run, hybrid_want)
    same_final("cli/hybrid_train.py pointnet2", out,
               os.path.join(tmp, "hybrid-again"))
    def_accs = [r["def_test_acc"] for r in run["records"] if "epoch" in r]
    meta = load_metadata(os.path.join(out, "best.npz"))
    print(f"    def_test_acc {def_accs}, best.npz at epoch {meta['epoch']}")
    if meta["epoch"] != 1 + int(np.argmax(def_accs)):
        fail(f"hybrid training kept epoch {meta['epoch']} as best, "
             f"def_test_acc {def_accs}")

    # resume: one epoch, then on to the second from its final checkpoint
    first = os.path.join(tmp, "resume_first")
    argv = ["--data", data, "--model", "pointnet2", "--batch_size",
            str(TRAIN_B), "--eval_every", "1", "--registry",
            registry + ".resume"]
    run = train_cli(argv + ["--epochs", "1", "--output", first])
    check_run("cli/train.py pointnet2, epoch 1", run,
              forwards_want("pointnet2", steps + evals, steps))
    saved = load_params_npz(os.path.join(first, "final.npz.opt.npz"))
    seen = {}
    restore = train.restore_checkpoint

    def spy(path, state):
        state, meta = restore(path, state)
        seen["step"] = state.step
        seen["adam"] = adam_state_to_jax(state.optimizer.state_dict(),
                                         state.model)
        return state, meta

    train.restore_checkpoint = spy
    try:
        run = train_cli(argv + ["--epochs", str(TRAIN_EPOCHS), "--output",
                                os.path.join(tmp, "resumed"), "--resume",
                                os.path.join(first, "final.npz")])
    finally:
        train.restore_checkpoint = restore
    check_run("cli/train.py pointnet2, --resume to epoch 2", run,
              forwards_want("pointnet2", steps + evals, steps))
    epochs = [r["epoch"] for r in run["records"] if "epoch" in r]
    moments_equal = all(
        np.array_equal(flatten_params(seen["adam"][k])[p],
                       flatten_params(saved["opt_state"][k])[p])
        for k in ("mu", "nu") for p in flatten_params(saved["opt_state"][k]))
    print(f"    resumed at step {seen['step']}, epochs {epochs}, Adam's "
          f"moments restored: {moments_equal}")
    if (seen["step"] != steps or int(saved["step"]) != steps or epochs != [2]
            or int(seen["adam"]["count"]) != steps or not moments_equal):
        fail(f"resume: step {seen['step']}, epochs {epochs}")
    return rates, total


def check_victim_training(dev) -> tuple[dict, dict, dict]:
    """Phase 14: (a) small steps CUDA vs CPU, (b) the train CLIs at full
    width, (c) a profile of a PointNet++ and a DGCNN train step. ->
    (steps/s, B5/B6 launches of (b), profiles)."""
    check_small_victim_training(dev)
    with tempfile.TemporaryDirectory() as tmp:
        rates, launches = run_train_clis(dev, tmp)
    profiles = {v: tool("profile_train_step").profile(dev, v, TRAIN_B)
                for v in ("pointnet2", "dgcnn")}
    return rates, launches, profiles


def mesh_inputs(variant: str, weights: str, devices, clouds: np.ndarray):
    """For each device: (the model of `weights` at the CLI's widths, its
    latent of `clouds`), the encoder subset drawn once on the CPU (SOR,
    the padded unit cube, `sample_valid`) and shared."""
    from if_defense_tpu_torch.cli import remesh_defense as rd
    from if_defense_tpu_torch.defense.ifdefense import sample_valid
    from if_defense_tpu_torch.defense.sor import sor_defense
    from if_defense_tpu_torch.ops import normalize_unit_cube

    args = rd.parse_args(["--variant", variant, "--data_root", "x.npz",
                          "--weights", weights])
    pc, mask = sor_defense(torch.from_numpy(clouds))
    proc = normalize_unit_cube(pc, args.padding_scale, mask)
    out = []
    for d in devices:
        model, input_n = rd.build_model(args, d)
        sel = sample_valid(proc, mask, input_n,
                           torch.Generator().manual_seed(15))
        with torch.no_grad():
            out.append((model, model.encode_inputs(sel.to(d))))
    return out


def quanta_apart(what: str, got: np.ndarray, want: np.ndarray) -> int:
    """Two int8 wire grids (as quanta) equal but at entries one quantum
    apart, at most 1e-3 of them (a logit that straddles a quantum boundary
    between the card's and the CPU's rounding); -> their count."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    n = int((diff > 0).sum())
    print(f"  {what}: int8 grids equal but at {n} of {diff.size} entries "
          f"(largest difference {int(diff.max())} quantum)")
    if diff.max() > 1 or n > 1e-3 * diff.size:
        fail(f"{what}: the card's int8 grid differs from the CPU's beyond "
             "quantum-boundary entries")
    return n


def check_small_mesh(dev, weights: dict) -> None:
    """Phase 15 (a): B = MESH_SMALL_B clouds at the CLI's widths with phase
    10's weights, resolution0 MESH_R0 x upsample MESH_U, the card against
    the port's CPU path on one encoder subset: ConvONet's dense lattice
    within MESH_TOL of the largest logit and its int8 grid equal but at
    quantum boundaries; ONet's coarse grid within MESH_TOL, its active
    voxels and top-k indices (under a budget that clips) equal, its int8
    grid equal but at quantum boundaries."""
    from if_defense_tpu_torch.implicit import generation as g

    iso = g.logit_threshold(0.2)
    clouds = ellipsoids(np.random.default_rng(15), MESH_SMALL_B)
    cpu = torch.device("cpu")
    rf = MESH_R0 * MESH_U

    def decode(m, p, c):
        return m.decode(p, c)

    (cm, cc), (gm, gc) = mesh_inputs("convonet", weights["convonet"],
                                     (cpu, dev), clouds)
    with torch.no_grad():
        want = cm.dense_lattice_logits(cc, rf, 1.1)
        got = gm.dense_lattice_logits(gc, rf, 1.1).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  convonet dense lattice (B={MESH_SMALL_B}, {rf + 1}^3): max "
          f"|card - CPU| {err:.3e} of largest logit {scale:.3f}")
    if err > MESH_TOL * scale:
        fail(f"convonet dense lattice: {err} > {MESH_TOL} x {scale}")
    qg = g.quantize_wire_int8(got, iso).numpy()
    qc = g.quantize_wire_int8(want, iso).numpy()
    quanta_apart("convonet dense lattice", qg, qc)
    x = (want.double().numpy() - iso) * 16
    off = (qg != qc) & (np.abs(x - np.round(x)) > 16 * err)
    if off.any():
        fail(f"convonet: {int(off.sum())} int8 entries differ away from a "
             "quantum boundary")

    (cm, cc), (gm, gc) = mesh_inputs("onet", weights["onet"], (cpu, dev),
                                     clouds)
    grid = torch.from_numpy(g.make_grid(MESH_R0, 1.1).reshape(1, -1, 3))
    res = {}
    for name, m, c in (("cpu", cm, cc), ("card", gm, gc)):
        d = next(m.parameters()).device
        coarse = g.eval_points_batched(
            decode, m, c, grid.to(d).expand(MESH_SMALL_B, -1, 3), 8192)
        flat, counts = g._active_scores(
            coarse.reshape((MESH_SMALL_B,) + (MESH_R0 + 1,) * 3), iso,
            r0=MESH_R0)
        res[name] = (coarse.cpu(), counts.cpu(), flat)
    k = max(1, int(res["cpu"][1].min()) // 2)
    err = float((res["card"][0] - res["cpu"][0]).abs().max())
    scale = float(res["cpu"][0].abs().max())
    idx = {n: g._topk_active(r[2], k)[0].cpu() for n, r in res.items()}
    print(f"  onet coarse grid (B={MESH_SMALL_B}, {MESH_R0 + 1}^3): max "
          f"|card - CPU| {err:.3e} of {scale:.3f}; active voxels "
          f"{res['card'][1].tolist()} (CPU {res['cpu'][1].tolist()}); "
          f"top-{k} indices {'equal' if torch.equal(*idx.values()) else 'DIFFER'}")
    if err > MESH_TOL * scale or not torch.equal(res["card"][1],
                                                 res["cpu"][1]) \
            or not torch.equal(idx["card"], idx["cpu"]):
        fail("onet coarse grid or active voxels differ between card and CPU")
    grids = [g.compute_value_grids(decode, m, c, resolution0=MESH_R0,
                                   upsample=MESH_U, wire="int8")[0]
             for m, c in ((gm, gc), (cm, cc))]
    quanta_apart("onet coarse + refine", *(np.round((v - iso) * 16)
                                            for v in grids))


def remesh_cli(data: str, weights: str, variant: str, *extra) -> dict:
    """One `cli/remesh_defense.py` run on the card: the output [n, 1024, 3]
    finite, each cloud's largest radius 1 within 1e-5, fewer fallbacks than
    clouds; clouds/s from the metrics sidecar."""
    from if_defense_tpu_torch.cli import remesh_defense
    from if_defense_tpu_torch.data import load_npz

    path, = remesh_defense.main(["--variant", variant, "--data_root", data,
                                 "--weights", weights, "--device", "cuda",
                                 *extra])
    with open(path + ".metrics.jsonl") as f:
        rec = json.loads(f.read().splitlines()[-1])
    out = load_npz(path).test_pc
    n = rec["clouds"]
    radius = np.sqrt((out.astype(np.float64) ** 2).sum(-1)).max(1)
    tag = f"{variant} {' '.join(extra)}".strip()
    print(f"  {tag}: {n} clouds, output {out.shape}, radius in "
          f"[{radius.min():.7f}, {radius.max():.7f}], "
          f"{rec['reconstruction_failures']} fallbacks, "
          f"{rec['clouds_per_sec']:.2f} clouds/s ({rec['seconds']:.2f} s)")
    if out.shape != (n, 1024, 3) or not np.isfinite(out).all():
        fail(f"remesh {tag}: output {out.shape} or non-finite values")
    if np.abs(radius - 1).max() > 1e-5:
        fail(f"remesh {tag}: a cloud's largest radius is not 1 within 1e-5")
    if not rec["reconstruction_failures"] < n:
        fail(f"remesh {tag}: {rec['reconstruction_failures']} fallbacks "
             f"of {n} clouds")
    return dict(path=path, out=out.copy(), rate=rec["clouds_per_sec"])


def run_remesh(weights: dict, keep: str, tmp: str) -> dict:
    """Phase 15 (b); see the module docstring. -> clouds/s per run."""
    from if_defense_tpu_torch.cli import inference
    from if_defense_tpu_torch.data import load_npz, save_npz

    d = load_npz(os.path.join(keep, "victims.npz"))
    files = {}
    for n in (VICTIM_CLOUDS, 2 * MESH_B, MESH_B, MESH_SAVE_CLOUDS):
        os.makedirs(os.path.join(tmp, str(n)), exist_ok=True)
        files[n] = save_npz(os.path.join(tmp, str(n), "victims.npz"), {
            "test_pc": d.test_pc[:n], "test_label": d.test_label[:n],
            "target_label": d.target_label[:n]})
    rates = {}
    for variant in ("convonet", "onet"):
        for tag in ("first", "warm"):
            rates[f"{variant} {tag}"] = remesh_cli(
                files[VICTIM_CLOUDS], weights[variant], variant)["rate"]
    runs = {w: remesh_cli(files[2 * MESH_B], weights["convonet"],
                          "convonet", "--wire", w) for w in ("int8", "sparse")}
    same = np.array_equal(runs["int8"]["out"], runs["sparse"]["out"])
    print(f"  convonet --wire sparse {'bit-identical' if same else 'DIFFERS'}"
          f" to --wire int8 over {2 * MESH_B} clouds")
    if not same:
        fail("the sparse wire's samples differ from the int8 wire's")
    rates.update({f"convonet {w}": r["rate"] for w, r in runs.items()})
    one = remesh_cli(files[MESH_B], weights["convonet"], "convonet",
                     "--host_workers", "1")
    many = remesh_cli(files[MESH_B], weights["convonet"], "convonet")
    same = np.array_equal(one["out"], many["out"])
    print(f"  convonet --host_workers 1 {'bit-identical' if same else 'DIFFERS'}"
          f" to one thread a core ({os.cpu_count()})")
    if not same:
        fail("the host thread count changed the samples")
    rates["convonet host_workers 1"] = one["rate"]
    mesh_dir = os.path.join(tmp, "meshes")
    rates["onet mesh"] = remesh_cli(files[MESH_SAVE_CLOUDS], weights["onet"],
                                    "onet", "--sample_mode", "mesh",
                                    "--save_mesh", mesh_dir)["rate"]
    exported = sorted(os.listdir(os.path.join(mesh_dir, "victims", "test")))
    print(f"  --save_mesh: {len(exported)} mesh files for {MESH_SAVE_CLOUDS} "
          "clouds")
    if not 0 < len(exported) <= MESH_SAVE_CLOUDS:
        fail(f"--save_mesh wrote {len(exported)} files for "
             f"{MESH_SAVE_CLOUDS} clouds")
    defended = remesh_cli(os.path.join(keep, "perturb.npz"), weights["onet"],
                          "onet")
    rates["onet perturb"] = defended["rate"]
    scored = inference.main(["--data", defended["path"], "--checkpoint",
                             os.path.join(keep, "pointnet2.npz"), "--mode",
                             "target", "--batch_size", str(ATTACK_B),
                             "--device", "cuda"])
    print(f"  ONet-Mesh on phase 13's perturb output, scored by PointNet++: "
          f"accuracy {scored['accuracy']:.4f}, target success "
          f"{scored['target_success']:.4f} over {scored['n']} clouds")
    if scored["n"] != ATTACK_B or not 0 <= scored["target_success"] <= 1:
        fail(f"scoring the defended perturb output: {scored}")
    return rates


def check_mesh_normals(dev, weights: str, clouds: np.ndarray) -> dict:
    """Phase 15 (c): `estimate_normals` on ConvONet for the vertices of one
    cloud's mesh at the CLI's resolution, B4's launch counters set to 0
    just before and read just after (one forward and one gradient-to-p
    launch a chunk of 8192 vertices); the normals held to the CPU path's:
    every vertex at cosine >= 0.99 and >= 99.99 % of them at >= 0.999 (a
    normal is a gradient's direction, and where the decoder's gradient
    nearly cancels, rounding turns it; the worst vertex's gradient norm
    against the median is printed). -> the launches."""
    from if_defense_tpu_torch.implicit import generation as g
    from if_defense_tpu_torch.ops import cuda_interp

    def decode(m, p, c):
        return m.decode(p, c)

    (cm, cc), (gm, gc) = mesh_inputs("convonet", weights,
                                     (torch.device("cpu"), dev), clouds[:1])
    rf = 32 * 4
    verts, tris = g.generate_meshes(
        decode, gm, gc, dense_eval_fn=g.make_convonet_dense_eval(gm, rf, 1.1))[0]
    for k in cuda_interp.launches:
        cuda_interp.launches[k] = 0
    got = g.estimate_normals(decode, gm, gc, verts)
    launches = dict(cuda_interp.launches)
    want_launch = -(-len(verts) // 8192)
    want = g.estimate_normals(decode, cm, cc, verts)
    cos = np.sum(got * want, -1)
    worst = int(np.argmin(cos))
    p = torch.from_numpy(verts).requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(decode(cm, p[None], cc).sum(), p)
    norm = grad.norm(dim=-1).numpy()
    low = int((cos < 0.999).sum())
    print(f"  estimate_normals on a {len(verts)}-vertex, {len(tris)}-face "
          f"ConvONet mesh: launches {launches} (want {want_launch} each "
          f"way); cosine to the CPU's: min {cos.min():.6f}, {low} vertices "
          f"below 0.999; the worst vertex's gradient norm "
          f"{norm[worst] / np.median(norm):.3e} of the median")
    if launches != {"plane_features": want_launch,
                    "plane_features_dp": want_launch,
                    "plane_features_dplane": 0, "plane_sample": 0,
                    "plane_sample_duv": 0, "plane_sample_dplane": 0}:
        fail(f"B4 launches {launches} in estimate_normals, not "
             f"{want_launch} forward and {want_launch} gradient to p")
    if cos.min() < 0.99 or low > 1e-4 * len(verts):
        fail(f"estimate_normals: card normals at cosine {cos.min()} to the "
             f"CPU's, {low} below 0.999")
    return launches


def check_mesh_path(dev, keep: str) -> tuple[dict, dict, list]:
    """Phase 15: (a) small runs CUDA vs CPU, (b) `cli/remesh_defense.py`
    at its defaults, (c) B4 in `estimate_normals`, (d) a profile of one
    warm batch of each variant. -> (clouds/s, B4's launches, profiles)."""
    from if_defense_tpu_torch.data import load_npz

    weights = {v: os.path.join(keep, f"{v}.npz") for v in ("convonet", "onet")}
    check_small_mesh(dev, weights)
    with tempfile.TemporaryDirectory() as tmp:
        rates = run_remesh(weights, keep, tmp)
    clouds = load_npz(os.path.join(keep, "victims.npz")).test_pc[:MESH_B]
    launches = check_mesh_normals(dev, weights["convonet"], clouds)
    print("  one warm batch of each variant, profiled "
          "(tools/profile_remesh_batch.py):")
    profiles = [tool("profile_remesh_batch").profile(
        dev, v, weights[v], clouds, MESH_B, reps=2)
        for v in ("convonet", "onet")]
    return rates, launches, profiles


def uv_inputs(dev, gen, b: int, q: int, c: int):
    """A plane N(0, 1) [b, R, R, c], uv from [-0.1, 1.1]^2 (the clamp holds
    about one coordinate in six) and the output's cotangent, f32."""
    def dev_(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return (dev_(gen.normal(size=(b, R, R, c))),
            dev_(gen.uniform(-0.1, 1.1, (b, q, 2))),
            dev_(gen.normal(size=(b, q, c))))


def check_plane_sample(dev, gen) -> dict:
    """B4's uv form (`plane_sample_cuda`) against `bilinear_plane_sample`,
    forward and both gradients, at B x Q = 48 x 1024 and 64x64 planes of
    32 channels (a ConvONet plane at caller-normalised coordinates) and 128
    (`FeatureDecoder`), then 6 (the scalar path; also B4's p form at 6),
    f32 and bf16 (against f32 copies, cast once): output bit-equal in f32,
    gradient to uv rtol 1e-4 and the plane's atol 1e-5 of the largest entry,
    rtol 2^-7 in bf16; two launches bit-identical. Times the 128-channel
    call (forward, gradients to uv and the plane), its plain version and
    one `F.grid_sample` call with the gradients to its grid and input."""
    from if_defense_tpu_torch.ops import cuda_interp, interp

    def grads(fn, plane, uv, g, harness=True):
        pl = plane.detach().requires_grad_(True)
        u = uv.detach().requires_grad_(True)
        out = fn(pl, u)
        d = (torch.autograd.grad((out.float() * g).sum(), [u, pl]) if harness
             else torch.autograd.grad(out, [u, pl], g.to(out.dtype)))
        return [out.detach(), *d]

    def plain(pl, u):
        return interp.bilinear_plane_sample(pl.float(), u.float()).to(pl.dtype)

    errs = []
    for c in (32, 128, 6):
        plane, uv, g = uv_inputs(dev, gen, B, N, c)
        for dt in (torch.float32, torch.bfloat16):
            args = (plane.to(dt), uv.to(dt), g)
            got = grads(cuda_interp.plane_sample_cuda, *args)
            want = grads(plain, *args)
            again = grads(cuda_interp.plane_sample_cuda, *args)
            for i, (a, w_, a2) in enumerate(zip(got, want, again)):
                tag = (f"uv form C={c} {('out', 'duv', 'dplane')[i]} "
                       f"{str(dt).split('.')[-1]}")
                rtol = ((1e-4 if i == 1 else 0.0) if dt == torch.float32
                        else 2.0**-7)
                e = compare(tag, a, w_, 1e-5 * float(w_.float().abs().max()),
                            rtol)
                if dt == torch.float32:
                    errs.append(e)
                    if i == 0 and not torch.equal(a, w_):
                        fail(f"B4 {tag}: not bit-equal to the plain version")
                if not torch.equal(a, a2):
                    fail(f"B4 {tag}: two launches differ")
    # the p form at 6 channels (the scalar path)
    p, planes, g_out = plane_inputs(dev, gen, 2, N)
    planes = {n: t[..., :6].contiguous() for n, t in planes.items()}
    g_out = g_out[..., :6].contiguous()
    for dt in (torch.float32, torch.bfloat16):
        pd = p.to(dt).requires_grad_(True)
        pls = {n: t.to(dt).requires_grad_(True) for n, t in planes.items()}
        outs = []
        for fn in (cuda_interp.plane_features_cuda,
                   lambda x, d: interp.plane_features(
                       x.float(), {n: t.float() for n, t in d.items()}).to(dt)):
            o = fn(pd, pls)
            outs.append([o.detach(), *torch.autograd.grad(
                (o.float() * g_out).sum(), [pd, *pls.values()])])
        for i, (a, w_) in enumerate(zip(*outs)):
            rtol = (1e-4 if i == 1 else 0.0) if dt == torch.float32 else 2.0**-7
            compare(f"p form C=6 {'out' if i == 0 else ('dp' if i == 1 else 'dplane')}"
                    f" {str(dt).split('.')[-1]}", a, w_,
                    1e-5 * float(w_.float().abs().max()), rtol)

    # the row: 128 channels, f32, forward and both gradients
    c = 128
    plane, uv, g = uv_inputs(dev, gen, B, N, c)
    nchw = plane.permute(0, 3, 1, 2)
    grid = (2 * uv - 1)[:, None]
    g_nchw = g.permute(0, 2, 1)[:, :, None, :]

    def library(harness=True):
        x = nchw.detach().requires_grad_(True)
        gr = grid.detach().requires_grad_(True)
        out = torch.nn.functional.grid_sample(
            x, gr, mode="bilinear", padding_mode="border", align_corners=True)
        if harness:
            return out, torch.autograd.grad((out * g_nchw).sum(), [gr, x])
        return torch.autograd.grad(out, [gr, x], g_nchw)

    diff = float((library()[0].detach()[:, :, 0].transpose(1, 2)
                  - grads(plain, plane, uv, g)[0]).abs().max())
    print(f"  one grid_sample call vs plain: max abs diff {diff:.3e}")
    rows_hit = touched_uv_rows(uv, R)
    nbytes = (4 * rows_hit * c + B * N * (8 + 8 + 2 * 4 * c)
              + 4 * B * R * R * c)          # uv, duv, g, out; dplane whole
    b_touched = bound(B * N * c * (10 + 12 + 10), nbytes)
    print(f"  bound: {rows_hit} of {B * R * R} corner rows touched, "
          f"{b_touched[0]:.4f} ms ({b_touched[1]})")
    print("  B4 uv form, FeatureDecoder's call (C=128), f32:")
    row = dict(
        name="plane_sample", id="B4",
        source="if_defense_tpu_torch/csrc/interp.cu",
        replaces="if_defense_tpu/ops/pallas_interp.py:233",
        max_abs_err=max(errs), bound=b_touched,
        **kernel_times(
            lambda: grads(cuda_interp.plane_sample_cuda, plane, uv, g),
            lambda: grads(interp.bilinear_plane_sample, plane, uv, g),
            lambda: grads(cuda_interp.plane_sample_cuda, plane, uv, g, False),
            ("features_fwd", "features_dp", "features_dplane"),
            library=(library, lambda: library(False))))
    print_row(row)
    return row


def touched_uv_rows(uv: torch.Tensor, res: int) -> int:
    """Distinct corner rows of one plane that the queries of every cloud
    touch, summed over the clouds."""
    x = (uv.clamp(0, 1) * (res - 1)).floor().long()
    x0, y0 = x[..., 0], x[..., 1]
    x1, y1 = (x0 + 1).clamp(max=res - 1), (y0 + 1).clamp(max=res - 1)
    cells = torch.cat([y0 * res + x0, y0 * res + x1, y1 * res + x0,
                       y1 * res + x1], 1)
    hit = torch.zeros((uv.shape[0], res * res), dtype=torch.bool,
                      device=uv.device)
    return int(hit.scatter_(1, cells, True).sum())


def seeded(make, variant: str, seed: int = 0, **config):
    """`make()` with `flax_init_params(seed, variant, **config)` perturbed
    (`perturbed`), in eval mode on the CPU."""
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    model = make()
    model.load_state_dict(params_from_jax(
        perturbed(flax_init_params(seed, variant, **config), seed + 1),
        model=model), strict=True)
    return model.eval()


def card_vs_cpu(dev, name: str, model, args, tol: float = GRID_TOL,
                train: bool = False, wrt=(0,), params: bool = True) -> None:
    """`model(*args)` (its outputs weighted by a ramp and summed) and the
    gradients to the arguments in `wrt` and, where `params`, to the
    parameters, on the card against the CPU from the same weights (copies,
    in train mode where `train`): each tensor within `tol` of the larger of
    its own largest magnitude and 1e-3 of the largest gradient (a bias that
    feeds a batch norm has a gradient of 0 but for rounding), a gradient to
    an input at >= 99.9 % of its entries."""
    import copy

    runs = []
    for d in ("cpu", dev):
        m = copy.deepcopy(model).to(d).train(train)
        xs = [a.to(d) for a in args]
        for i in wrt:
            xs[i] = xs[i].detach().requires_grad_(True)
        outs = m(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * torch.linspace(
            0.5, 1.5, o.numel(), device=o.device).reshape(o.shape)).sum()
            for o in outs)
        wrt_t = [xs[i] for i in wrt] + (list(m.parameters()) if params else [])
        grads = torch.autograd.grad(loss, wrt_t, allow_unused=True)
        runs.append(([o.detach().float().cpu() for o in outs],
                     [torch.zeros(1) if g is None else g.detach().cpu()
                      for g in grads]))
    (co, cg), (go, gg) = runs
    floor = 1e-3 * max(float(t.abs().max()) for t in cg)
    worst, beyond = 0.0, 0.0
    for i, (a, b) in enumerate(list(zip(go, co)) + list(zip(gg, cg))):
        is_grad = i >= len(co)
        scale = max(float(b.abs().max()), floor if is_grad else 0.0, 1e-30)
        err = (a - b).abs() / scale
        if is_grad and i - len(co) < len(wrt):
            # a gradient to an input: a ReLU within rounding of its kink
            # passes on one device only, so >= 99.9 % of the entries
            beyond = max(beyond, float((err > tol).float().mean()))
            err = err.flatten().kthvalue(
                max(1, int(np.ceil(0.999 * err.numel())))).values
        worst = max(worst, float(err.max()))
    print(f"  {name}: {len(co)} outputs and {len(cg)} gradients, worst error "
          f"{worst:.2e} of the scale (tol {tol:g}; inputs' gradients at their "
          f"99.9th percentile, {beyond:.1e} of entries beyond)")
    if worst > tol:
        fail(f"{name}: the card disagrees with the CPU path")


def check_small_grid(dev) -> None:
    """(a) small runs, the card against the CPU path from the same
    perturbed `flax_init_params`: the grid ConvONet at full width on 2
    clouds (encode, decode, gradient to p), PointConvONet (B5/B6 inside),
    the five registry decoders in train mode, `LatentEncoder` (both
    `leaky`), `VoxelDecoder` and `FeatureDecoder` (c_dim 6 and 128: B4's uv
    form on the card), forward and backward with z_dim > 0. TF32 off."""
    from if_defense_tpu_torch.implicit import (
        ConvOccupancyNetwork,
        FeatureDecoder,
        LatentEncoder,
        VoxelDecoder,
    )
    from if_defense_tpu_torch.implicit.onet import DECODER_REGISTRY
    from if_defense_tpu_torch.implicit.pointnetpp_encoder import PointConvONet

    gen = np.random.default_rng(16)

    def t(shape, lo=0.5):
        return torch.from_numpy(gen.uniform(-lo, lo, shape).astype(np.float32))

    grid = seeded(lambda: ConvOccupancyNetwork(plane_type=("grid",)),
                  "convonet", plane_type=("grid",))
    # queries at least 0.01 cell from the 32^3 volume's cell edges, where
    # the trilinear gradient jumps and one ulp of the normalisation (the
    # card multiplies by the reciprocal, the CPU divides) picks the side;
    # cells 0-29: the clamp's top, 1 - 1e-3, cuts the last cell
    cell = gen.integers(0, 30, (2, 2048, 3)) + gen.uniform(0.01, 0.99,
                                                            (2, 2048, 3))
    pc = t((2, 600, 3))
    q = torch.from_numpy(((cell / 31 - 0.5) * 1.101).astype(np.float32))

    class EncodeDecode(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, q, pc):
            c = self.m.encode_inputs(pc)
            return self.m.decode(q, c), c["grid"]

    card_vs_cpu(dev, "grid ConvONet encode + decode", EncodeDecode(grid),
                [q, pc], params=False)
    pconv = seeded(PointConvONet, "pointconvonet")
    card_vs_cpu(dev, "PointConvONet", pconv, [t((2, 600, 3)),
                                              t((2, 512, 3), 0.55)], wrt=(1,))
    c_dim, z_dim, hid = 32, 16, 64
    p, c, z = t((4, 256, 3)), t((4, c_dim), 1.0), t((4, z_dim), 1.0)
    kws = {"simple": dict(hidden_size=hid, c_dim=c_dim, z_dim=z_dim),
           "cbatchnorm": dict(c_dim=c_dim, hidden_size=hid, z_dim=z_dim),
           "cbatchnorm2": dict(hidden_size=hid, c_dim=c_dim, z_dim=z_dim),
           "batchnorm": dict(hidden_size=hid, c_dim=c_dim, z_dim=z_dim),
           "cbatchnorm_noresnet": dict(c_dim=c_dim, hidden_size=hid,
                                       z_dim=z_dim)}
    for name, cls in DECODER_REGISTRY.items():
        for train in (False, True):
            torch.manual_seed(0)
            # in train mode the batch statistics' backward subtracts the
            # batch means: a gradient is a difference of terms of the
            # larger size, and the card's reductions add in their own order
            card_vs_cpu(dev, f"decoder {name} ({('eval', 'train')[train]} "
                        "mode)", cls(**kws[name]), [p, c, z], train=train,
                        tol=GRID_TRAIN_TOL if train else GRID_TOL)
    occ = torch.from_numpy((gen.uniform(size=(4, 256)) > 0.5).astype(np.float32))
    for leaky in (False, True):
        torch.manual_seed(0)
        card_vs_cpu(dev, f"LatentEncoder leaky={leaky}",
                    LatentEncoder(z_dim, c_dim, 128, leaky), [p, occ, c])
    torch.manual_seed(0)
    card_vs_cpu(dev, "VoxelDecoder", VoxelDecoder(z_dim, c_dim, hid),
                [p, c, z])
    for cd in (6, 128):
        torch.manual_seed(0)
        card_vs_cpu(dev, f"FeatureDecoder c_dim {cd}",
                    FeatureDecoder(z_dim, cd, hid),
                    [p, t((4, 64, 64, cd), 1.0), z], wrt=(0, 1))


def grid_training(dev, occ_npz: str):
    """(b) the grid ConvONet at full width (c_dim 32, hidden 32, 32^3, 3D
    UNet depth 3) from `flax_init_params(0)`, `TRAIN_STEPS` steps of
    `make_occupancy_train_step` at lr `TRAIN_LR` on phase 10's batch (32
    shapes x 2048 queries, 600 input points) of its occupancy npz, under
    deterministic algorithms as `cli/train_implicit.py` runs. Step 1 first
    on the CPU and twice on the card from the same weights on 2 of the
    shapes: loss rtol 1e-5, the decoder's gradients rtol 1e-4 and atol
    1e-4 of each tensor's largest (phase 9's bounds), the encoder's at
    cosine >= ENCODER_COS (the 3D UNet's convolutions sum in cuDNN's
    order), and the card's two runs' gradients bit-equal; the weights
    perturbed for that step as phase 9's (flax's zero biases put
    pre-activations at ReLU's kink). Then the `TRAIN_STEPS` steps twice
    from one seed, the final weights bit-equal, with the encoder's launch
    counters set to 0 just before and read just after (a step: the
    pooled max 4 forward and 4 backward, the scatter-mean 1, and the
    gather backward 8, the volume's eight corner gathers in the decoder).
    -> (model on the card, steps/s of each run, encoder launches)."""
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.implicit.training import (
        OccupancyBatchSampler,
        init_occupancy_model,
        make_occupancy_train_step,
    )
    from if_defense_tpu_torch.ops import cuda_csr, cuda_gather, cuda_scatter
    from if_defense_tpu_torch.utils.determinism import deterministic
    from if_defense_tpu_torch.utils.params_io import params_from_jax

    with np.load(occ_npz) as z:
        arrays = (z["pointcloud"], z["points"], z["points_occ"])
    small = OccupancyBatchSampler(*arrays, pointcloud_n=600,
                                  points_subsample=TQ, seed=1).sample(2)
    runs = []
    with deterministic():
        for d in ("cpu", dev, dev):
            model = ConvOccupancyNetwork(plane_type=("grid",))
            model.load_state_dict(params_from_jax(
                perturbed(init_occupancy_model(model, 0), 1), model))
            model.to(d)
            _, step = make_occupancy_train_step(model, TRAIN_LR)
            loss = float(step(*(torch.from_numpy(a).to(d)
                                for a in small))["loss"])
            runs.append((loss, {n: p.grad.detach().cpu()
                                for n, p in model.named_parameters()}))

    def gap(got: dict, ref: dict):
        """(the decoder's worst error / bound, the encoder's least cosine,
        [(error / bound, cosine, name, entries past the bound, entries)])
        of `got`'s gradients to `ref`'s."""
        worst, cos_min, table = 0.0, 1.0, []
        for n, r in ref.items():
            a = got[n]
            over = (a - r).abs() / (1e-4 * float(r.abs().max())
                                    + 1e-4 * r.abs() + 1e-30)
            err = float(over.max())
            cos = float(torch.nn.functional.cosine_similarity(
                a.flatten().double(), r.flatten().double(), 0))
            table.append((err, cos, n, int((over > 1).sum()), over.numel()))
            if n.startswith("decoder."):
                worst = max(worst, err)
            else:
                cos_min = min(cos_min, cos)
        return worst, cos_min, table

    # the decoder's gradients to phase 9's bounds; the encoder's pass
    # through the 3D UNet, whose cuDNN convolutions reduce over 2 x 32^3
    # positions and 27 taps in their own order (a step's worst entry was
    # 3e-3 of its tensor's largest, in the 8^3 x 128-channel bottom level),
    # in direction, to ENCODER_COS
    (lc, gc), (lg, gg), (lg2, gg2) = runs
    worst, cos_min, table = gap(gg, gc)
    for err, cos, n, past, size in sorted(table, reverse=True)[:3]:
        print(f"    {n}: error / bound {err:.3f} ({past} of {size} entries "
              f"past it), cosine {cos:.7f}")
    print(f"  step 1 on 2 shapes: loss CPU {lc:.6f}, card {lg:.6f}; the "
          f"decoder's gradients worst error / bound {worst:.3f}, the "
          f"encoder's cosine >= {cos_min:.7f}")
    same = sum(same_bits(gg2[n], gg[n]) for n in gg)
    print(f"  the card's second step 1 against its first: loss {lg2:.6f}, "
          f"{same} of {len(gg)} gradients bit-equal")
    if abs(lg - lc) > 1e-5 * abs(lc) or worst > 1 or cos_min < ENCODER_COS:
        fail("grid ConvONet step 1 on the card disagrees with the CPU")
    if same != len(gg) or lg2 != lg:
        fail(f"grid ConvONet step 1 twice on the card: {same} of {len(gg)} "
             "gradients bit-equal")

    sampler = OccupancyBatchSampler(*arrays, pointcloud_n=600,
                                    points_subsample=TQ, seed=0)
    batches = [sampler.sample(TB) for _ in range(TRAIN_STEPS)]
    for counter in (cuda_scatter.launches, cuda_gather.launches,
                    cuda_csr.launches):
        for k in counter:
            counter[k] = 0
    rates, weights = [], []
    with deterministic():
        for run in ("first", "second"):
            model = ConvOccupancyNetwork(plane_type=("grid",))
            init_occupancy_model(model, 0)
            model.to(dev)
            _, step = make_occupancy_train_step(model, TRAIN_LR)
            torch.cuda.reset_peak_memory_stats()
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                losses.append(step(*(torch.from_numpy(a).to(
                    dev, non_blocking=True) for a in b))["loss"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            losses = [float(x) for x in losses]
            if not all(np.isfinite(losses)):
                fail(f"grid ConvONet training: non-finite losses {losses}")
            rates.append(TRAIN_STEPS / seconds)
            weights.append({n: p.detach().cpu()
                            for n, p in model.state_dict().items()})
            print(f"  {run} run, {TRAIN_STEPS} steps at batch {TB} x {TQ}: "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{rates[-1]:.3f} steps/s (host clock, data on the host "
                  f"included), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = dict(cuda_scatter.launches)
    gathers = cuda_gather.launches["gather_backward"]
    csr = cuda_csr.launches["csr"]
    same = all(same_bits(weights[0][n], weights[1][n]) for n in weights[0])
    print(f"  the two runs' weights bit-equal {same}; encoder launches "
          f"{launches}, gather backward {gathers}, CSR builds {csr}")
    if not same:
        fail("two seeded grid ConvONet training runs differ")
    want = 2 * TRAIN_STEPS
    if launches != {"scatter_mean": want, "pooled_max": 4 * want,
                    "pooled_max_backward": 4 * want}:
        fail(f"encoder launches {launches} in grid training, not {want} "
             f"scatter-mean and {4 * want} pooled max each way")
    if gathers != 8 * want:
        fail(f"gather-backward launches {gathers} in grid training, not "
             f"{8 * want} (the volume's eight corners a step)")
    if csr != want + gathers:
        fail(f"CSR builds {csr} in grid training, not {want} (the grid's "
             f"one a step, which its 4 pooled maxes and its scatter-mean "
             f"share) plus {gathers} (one a gather backward)")
    return (model.eval().requires_grad_(False), rates,
            launches | {"gather_backward": gathers, "csr": csr})


def grid_defense(dev, model) -> tuple[dict, dict]:
    """(c) `convonet_opt_defense` with the trained grid model on phase 4's
    48 x 1024 clouds, 600 encoder points, 201 steps: the reference mode in
    f32 (launch counters set to 0 just before and read just after: B1 402,
    B4 none), `interp_refresh=16` (a grid keeps the exact path: the same
    bits, under deterministic algorithms), and bf16; every cloud's largest
    radius within 1 + 1e-5.
    -> ({mode: clouds/s}, launches of the reference run)."""
    from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
    from if_defense_tpu_torch.ops import cuda_interp, cuda_repulsion

    pc = torch.from_numpy(ellipsoids(np.random.default_rng(0), B)).to(dev)
    modes = {"reference f32": {}, "interp_refresh 16": {"interp_refresh": 16},
             "bf16": {"compute_dtype": "bfloat16"}}
    outs, rates, launches = {}, {}, {}
    # deterministic algorithms on for the bits, as cli/remesh_defense.py
    # runs (the encoder's scatter-mean repeats its bits either way)
    torch.use_deterministic_algorithms(True)
    for name, kw in modes.items():
        defend = convonet_opt_defense(model, **kw)
        counters = (cuda_repulsion.launches, cuda_interp.launches)
        for counter in counters:
            for k in counter:
                counter[k] = 0
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = defend(pc, gen)
        torch.cuda.synchronize()
        rates[name] = B / (time.perf_counter() - t0)
        if name == "reference f32":
            launches = {k: v for c in counters for k, v in c.items()}
        radius = float(out.norm(dim=-1).amax(1).max())
        print(f"  {name}: {tuple(out.shape)}, max radius {radius:.7f}, "
              f"{rates[name]:.3f} clouds/s")
        if (not torch.isfinite(out).all() or radius > 1 + 1e-5
                or out.shape != (B, 1024, 3)):
            fail(f"grid ConvONet-Opt {name}: bad output")
        outs[name] = out
    torch.use_deterministic_algorithms(False)
    print(f"  reference launches {launches}")
    if launches["repulsion_loss"] != 402 or any(
            launches[k] for k in cuda_interp.launches):
        fail(f"grid ConvONet-Opt launches {launches}: not B1 402, B4 none")
    if not torch.equal(outs["reference f32"], outs["interp_refresh 16"]):
        fail("grid ConvONet-Opt: interp_refresh 16 differs from the "
             "reference mode")
    return rates, launches


def grid_mesh(dev, model) -> dict:
    """(d) the mesh path on the grid model: `cli/remesh_defense.py`'s
    `defend_clouds` at its defaults (batch 32, resolution0 32 x upsample 4:
    a 129^3 lattice through the exact coarse + refine path, since the
    lattice evaluators decline a grid; 1024 points a cloud) on 32
    ellipsoids, twice (first and warm run), then `generate_meshes` on the
    same encoder subset; output finite, each cloud's largest radius 1
    within 1e-5, fewer fallbacks than clouds; the warm batch's device time
    by torch.profiler. -> rates and device time."""
    from torch.profiler import ProfilerActivity, profile

    from if_defense_tpu_torch.cli import remesh_defense as rd
    from if_defense_tpu_torch.implicit import generation as g

    args = rd.parse_args(["--variant", "convonet", "--data_root", "-",
                          "--weights", "-"])
    if (g.make_convonet_dense_eval(model, 128, 1.1) is not None
            or g.make_convonet_lattice_eval(model, 128, 1.1) is not None):
        fail("a lattice evaluator took the grid model")
    dense_fn, _, decode_fn, encode_fn = rd.build_eval_fns(args, model)
    if dense_fn is not None:
        fail("build_eval_fns gave the grid model a dense evaluator")
    pc = ellipsoids(np.random.default_rng(17), MESH_B)
    out = {}
    for tag in ("first", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clouds, fails = rd.defend_clouds(model, 600, pc, args,
                                         decode_fn=decode_fn,
                                         encode_fn=encode_fn)
        out[tag] = MESH_B / (time.perf_counter() - t0)
        radius = np.linalg.norm(clouds, axis=-1).max(1)
        print(f"  defend_clouds {tag}: {clouds.shape}, radius in "
              f"[{radius.min():.7f}, {radius.max():.7f}], {fails} fallbacks, "
              f"{out[tag]:.3f} clouds/s")
        if (clouds.shape != (MESH_B, 1024, 3) or not np.isfinite(clouds).all()
                or np.abs(radius - 1).max() > 1e-5 or fails >= MESH_B):
            fail(f"grid mesh path ({tag}): bad output")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rd.defend_clouds(model, 600, pc, args, decode_fn=decode_fn,
                         encode_fn=encode_fn)
        torch.cuda.synchronize()
    events = device_events(prof)
    out["device_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  a warm batch's device time {out['device_ms']:.3f} ms; top:")
    print_top(events, 5)
    from if_defense_tpu_torch.ops import normalize_unit_cube

    sel = normalize_unit_cube(torch.from_numpy(pc[:, :600]).to(dev), 0.9)
    with torch.no_grad():
        c = model.encode_inputs(sel)
    meshes = g.generate_meshes(decode_fn, model, c, resolution0=32, upsample=4)
    faces = [len(t) for _, t in meshes]
    print(f"  generate_meshes: {len(meshes)} meshes, faces "
          f"{min(faces)}-{max(faces)}")
    if len(meshes) != MESH_B or sum(f > 0 for f in faces) == 0:
        fail("generate_meshes gave no surface on the grid model")
    return out


def point_conv_onet_run(dev) -> tuple[dict, float]:
    """(e) PointConvONet at its defaults from `flax_init_params(0)`
    perturbed: encode 48 x 600 and decode 1024 queries with the gradient
    to p, launch counters set to 0 just before and read just after (B5 2
    and B6 2: two set-abstraction levels). -> (launches, calls/s of a warm
    call)."""
    from if_defense_tpu_torch.implicit.pointnetpp_encoder import PointConvONet
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps

    model = seeded(PointConvONet, "pointconvonet").to(dev)
    gen = np.random.default_rng(18)
    pc = torch.from_numpy(ellipsoids(gen, B)[:, :600] / 2).to(dev)
    q = torch.from_numpy(gen.uniform(-0.55, 0.55, (B, N, 3)).astype(
        np.float32)).to(dev)

    def call():
        x = q.detach().requires_grad_(True)
        logits = model.decode(x, model.encode_inputs(pc))
        return logits, torch.autograd.grad(logits.sum(), x)[0]

    counters = (cuda_fps.launches, cuda_ballquery.launches)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    logits, dx = call()
    launches = {k: v for c in counters for k, v in c.items()}
    ms = median_ms(call)
    print(f"  logits {tuple(logits.shape)}, launches {launches}, a warm call "
          f"{ms:.3f} ms")
    if (not torch.isfinite(logits).all() or not torch.isfinite(dx).all()
            or launches.get("fps") != 2 or launches.get("ballquery") != 2):
        fail(f"PointConvONet: launches {launches} (not B5 2, B6 2) or "
             "non-finite output")
    return launches, 1e3 / ms


def uv_form_run(dev) -> dict:
    """(f) B4's uv form on its two places in the library, launch counters
    set to 0 just before and read just after: `FeatureDecoder` at its
    defaults (z 128, c 128, hidden 256) on a [48, 64, 64, 128] map and 1024
    queries, forward and backward to the points and the map (uv form: 1
    forward, 1 uv gradient, 1 plane gradient), and the plane ConvONet's
    `decode` with caller-normalised coordinates `p_n` (48 x 1024, three
    64x64x32 planes: 3 forward launches)."""
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork, FeatureDecoder
    from if_defense_tpu_torch.implicit.convonet import PLANES
    from if_defense_tpu_torch.ops import cuda_interp, normalize_coordinate

    gen = np.random.default_rng(19)
    torch.manual_seed(0)
    fdec = FeatureDecoder().to(dev)
    conv = seeded(ConvOccupancyNetwork, "convonet").to(dev)
    p = torch.from_numpy(gen.uniform(-0.5, 0.5, (B, N, 3)).astype(
        np.float32)).to(dev).requires_grad_(True)
    fmap = torch.from_numpy(gen.normal(size=(B, R, R, 128)).astype(
        np.float32)).to(dev).requires_grad_(True)
    z = torch.from_numpy(gen.normal(size=(B, 128)).astype(np.float32)).to(dev)
    planes = {n: torch.from_numpy(gen.normal(size=(B, R, R, C)).astype(
        np.float32)).to(dev) for n in PLANES}
    for k in cuda_interp.launches:
        cuda_interp.launches[k] = 0
    out = fdec(p, fmap, z)
    dp, dmap = torch.autograd.grad(out.sum(), [p, fmap])
    with torch.no_grad():
        p_n = {n: normalize_coordinate(p, n) for n in PLANES}
        logits = conv.decode(p, planes, p_n)
        want = conv.decode(p, planes)
    launches = dict(cuda_interp.launches)
    print(f"  FeatureDecoder out {tuple(out.shape)}, decode with p_n max "
          f"diff to decode {float((logits - want).abs().max()):.3e}; "
          f"launches {launches}")
    if (launches["plane_sample"] != 4 or launches["plane_sample_duv"] != 1
            or launches["plane_sample_dplane"] != 1
            or not torch.isfinite(out).all() or not torch.isfinite(dp).all()
            or not torch.isfinite(dmap).all()
            or float((logits - want).abs().max())
            > 1e-5 * float(want.abs().max())):
        fail(f"B4's uv form on the path: launches {launches} (not 4, 1, 1) "
             "or bad output")
    return launches


def check_grid_path(dev, occ_npz: str) -> tuple[dict, dict, dict]:
    """Phase 16. -> (rates, launches by run, the uv form's kernel row)."""
    t0 = time.perf_counter()
    print("  (a) B4's uv form against its plain version, then small runs on "
          "the card against the CPU path")
    row = check_plane_sample(dev, np.random.default_rng(20))
    check_small_grid(dev)
    print(f"  (b) the grid ConvONet, {TRAIN_STEPS} training steps at full "
          "width")
    model, train_rates, train_launches = grid_training(dev, occ_npz)
    print("  (c) grid ConvONet-Opt, 48 x 1024, 201 steps")
    defense_rates, defense_launches = grid_defense(dev, model)
    print(f"  (d) the grid mesh path, batch {MESH_B}, a 129^3 lattice")
    mesh = grid_mesh(dev, model)
    print("  (e) PointConvONet, 48 x 600 encoded, 1024 queries with the "
          "gradient to p")
    pconv_launches, pconv_rate = point_conv_onet_run(dev)
    print("  (f) B4's uv form in FeatureDecoder and decode with p_n")
    uv_launches = uv_form_run(dev)
    rates = {"train steps/s": train_rates, "opt clouds/s": defense_rates,
             "mesh clouds/s": {k: mesh[k] for k in ("first", "warm")},
             "mesh batch device ms": mesh["device_ms"],
             "PointConvONet calls/s": pconv_rate}
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    return rates, {"grid": defense_launches, "grid_train": train_launches,
                   "pointconv": pconv_launches, "uv": uv_launches}, row


SUPPORT_VICTIMS = ("pointnet", "dgcnn", "pointnet2", "pointconv")
# the shipped configs' contents, where PyYAML is not installed
SHIPPED_CONFIGS = {
    "convonet_3plane_mn40.yaml": {
        "method": "conv_onet", "data": {"pointcloud_n": 600, "padding": 0.1},
        "model": {"c_dim": 32, "encoder_kwargs": {
            "hidden_dim": 32, "plane_resolution": 64}}},
    "onet_mn40.yaml": {
        "method": "onet", "data": {"pointcloud_n": 300},
        "model": {"c_dim": 512, "encoder_kwargs": {"hidden_dim": 512},
                  "decoder_kwargs": {"hidden_size": 256}}},
}


def counters() -> tuple:
    """Every kernel wrapper's launch counter."""
    from if_defense_tpu_torch.ops import (
        cuda_ballquery,
        cuda_csr,
        cuda_fps,
        cuda_gather,
        cuda_interp,
        cuda_repulsion,
        cuda_scatter,
    )

    return (cuda_repulsion.launches, cuda_interp.launches, cuda_fps.launches,
            cuda_ballquery.launches, cuda_scatter.launches,
            cuda_gather.launches, cuda_csr.launches)


def all_launches() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def zero_launches() -> None:
    for c in counters():
        for k in c:
            c[k] = 0


def same_tree(what: str, got: dict, want: dict) -> None:
    from if_defense_tpu_torch.utils.params_io import flatten_params

    got, want = flatten_params(got), flatten_params(want)
    if got.keys() != want.keys() or any(
            not np.array_equal(got[k], want[k]) for k in got):
        fail(f"{what}: the converted tree is not its source, leaf for leaf")


def converted_weights(dev, tmp: str) -> tuple[dict, dict, dict]:
    """Phase 17 (a)'s weights: each seeded tree written as the reference's
    `.pth` and converted back from the file. -> (seeded files, converted
    files, seconds a conversion took)."""
    from if_defense_tpu_torch.cli.defend_npz import DEFAULT_PUNET_WEIGHTS
    from if_defense_tpu_torch.convert import (
        implicit_weights,
        punet_weights,
        victim_weights,
    )
    from if_defense_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        init_params,
        load_params_npz,
        params_to_jax,
        save_params_npz,
    )

    ref = tool("reference_pth")
    trees = {"convonet": init_params(0), "onet": flax_init_params(0, "onet"),
             "punet": load_params_npz(DEFAULT_PUNET_WEIGHTS)}
    clouds = victim_clouds(np.random.default_rng(17), VICTIM_B)
    for name in SUPPORT_VICTIMS:
        model = seeded_victim(name, dev, clouds)
        trees[name] = params_to_jax(model.state_dict(), model)
        del model
    convert = {"convonet": implicit_weights.convert_convonet_pth,
               "onet": implicit_weights.convert_onet_pth,
               "punet": punet_weights.convert_punet_pth,
               **{n: getattr(victim_weights, f"convert_{n}_pth")
                  for n in SUPPORT_VICTIMS}}
    seeded, converted, seconds = {}, {}, {}
    for kind, tree in trees.items():
        pth = os.path.join(tmp, f"{kind}.pth")
        torch.save(ref.reference_state_dict(
            kind, tree, module_prefix=kind == "pointnet2"), pth)
        t0 = time.perf_counter()
        out = convert[kind](pth)
        seconds[kind] = time.perf_counter() - t0
        same_tree(kind, out, tree)
        if kind in SUPPORT_VICTIMS:
            seeded[kind] = save_eval_checkpoint(
                os.path.join(tmp, f"{kind}-seeded.npz"), tree, {"model": kind})
            converted[kind] = save_eval_checkpoint(
                os.path.join(tmp, f"{kind}-converted.npz"), out,
                {"model": kind})
        else:
            seeded[kind] = save_params_npz(
                os.path.join(tmp, f"{kind}-seeded.npz"), tree)
            converted[kind] = save_params_npz(
                os.path.join(tmp, f"{kind}-converted.npz"), out)
        print(f"  {kind}: {os.path.getsize(pth) / 2**20:.1f} MiB .pth, "
              f"converted in {seconds[kind] * 1e3:.1f} ms, equal to its "
              "source tree")
    return seeded, converted, seconds


def support_opt_run(dev, data: str, weights: str,
                    devices=None) -> np.ndarray:
    """`cli/opt_defense.py` in the reference mode at phase 4's settings on
    `data` (`--device cuda` for a card); the restored clouds."""
    from if_defense_tpu_torch.cli import opt_defense
    from if_defense_tpu_torch.data import load_npz

    out, = opt_defense.main([
        "--data_root", data, "--weights", weights, "--batch_size", str(B),
        "--iterations", "200", "--sample_npoint", "1024", "--seed", "1",
        "--device", dev.type], devices=devices)
    got = load_npz(out).test_pc
    if got.shape != (B, 1024, 3) or not np.isfinite(got).all():
        fail(f"opt_defense on {data}: output {got.shape} or non-finite")
    return got


def check_converted(dev, tmp: str, seeded: dict, converted: dict) -> dict:
    """Phase 17 (a): each converted file against its seeded twin through
    the CLIs. -> the launches of the runs on converted weights."""
    from if_defense_tpu_torch.cli import defend_npz, inference
    from if_defense_tpu_torch.cli.inference import load_eval_model
    from if_defense_tpu_torch.data import load_npz, save_npz

    pc = ellipsoids(np.random.default_rng(0), B)
    runs = {}
    for tag in ("cli", "seeded", "converted"):
        data = save_npz(os.path.join(tmp, f"opt-{tag}", "x.npz"),
                        {"test_pc": pc, "test_label": np.arange(B) % 40})
        before = all_launches()
        # the first run as the CLI runs, without deterministic algorithms;
        # the seeded and converted runs deterministic
        torch.use_deterministic_algorithms(tag != "cli")
        runs[tag] = support_opt_run(dev, data, (
            seeded if tag == "seeded" else converted)["convonet"])
        run_launches = {k: v - before[k] for k, v in all_launches().items()}
    gap = np.abs(runs["cli"] - runs["seeded"])
    same = np.array_equal(runs["cli"], runs["seeded"])
    print(f"  opt_defense as the CLI runs against a deterministic run: "
          f"bit-equal {same}, {float((gap <= 1e-4).mean()):.6f} of "
          f"coordinates within 1e-4, max abs diff {float(gap.max()):.3e}")
    if not same:
        fail("cli/opt_defense.py as it runs is not bit-equal to its run "
             "under deterministic algorithms")
    print(f"  opt_defense on converted ConvONet weights: launches "
          f"{ {k: v for k, v in run_launches.items() if v} }")
    if (run_launches["repulsion_loss"] != 402
            or run_launches["plane_features"] != 201
            or run_launches["plane_features_dp"] != 201):
        fail(f"launches {run_launches} in opt_defense on converted weights, "
             "not B1 402 and B4 201 + 201")
    if not np.array_equal(runs["seeded"], runs["converted"]):
        fail("opt_defense on converted ConvONet weights is not bit-equal to "
             "the run on the seeded tree")
    print("  opt_defense: converted == seeded, bit for bit")

    clouds = ellipsoids(np.random.default_rng(7), DUP_B)
    outs = {}
    for tag, weights in (("seeded", seeded["punet"]),
                         ("converted", converted["punet"])):
        data = save_npz(os.path.join(tmp, f"dup-{tag}", "adv.npz"),
                        {"test_pc": clouds,
                         "test_label": np.arange(DUP_B) % 40})
        before = all_launches()
        path, = defend_npz.main(["--data_root", data, "--device", dev.type,
                                 "--defense", "dup", "--punet_weights",
                                 weights])
        dup_launches = {k: all_launches()[k] - before[k]
                        for k in ("fps", "ballquery")}
        outs[tag] = load_npz(path).test_pc
    print(f"  DUP-Net (defend_npz) on the converted PU-Net: launches "
          f"{dup_launches}")
    if dup_launches != {"fps": 4, "ballquery": 4}:
        fail(f"B5/B6 launches {dup_launches} in DUP-Net, not 4 each")
    if not np.array_equal(outs["seeded"], outs["converted"]):
        fail("DUP-Net on the converted PU-Net is not bit-equal")
    print("  DUP-Net: converted == repository weights, bit for bit")

    vclouds = victim_clouds(np.random.default_rng(18), 2 * VICTIM_B)
    label = np.arange(2 * VICTIM_B) % 40
    data = save_npz(os.path.join(tmp, "victims.npz"), {
        "test_pc": vclouds.numpy(), "test_label": label,
        "target_label": (label + 7) % 40})
    for name in SUPPORT_VICTIMS:
        records = [inference.main(["--data", data, "--checkpoint", ckpt,
                                   "--batch_size", str(VICTIM_B), "--mode",
                                   "target", "--device", dev.type])
                   for ckpt in (seeded[name], converted[name])]
        with torch.no_grad():
            logits = [load_eval_model(ckpt)[0].to(dev)(
                vclouds[:VICTIM_B].to(dev))[0]
                for ckpt in (seeded[name], converted[name])]
        drop = ("data",)
        same = ({k: v for k, v in records[0].items() if k not in drop}
                == {k: v for k, v in records[1].items() if k not in drop})
        print(f"  {name}: converted accuracy {records[1]['accuracy']:.4f}, "
              f"target success {records[1]['target_success']:.4f}; the same "
              f"record {same}, logits bit-equal "
              f"{torch.equal(logits[0], logits[1])}")
        if not same or not torch.equal(logits[0], logits[1]):
            fail(f"{name}: the converted checkpoint scores otherwise than "
                 "the seeded one")
    return run_launches


def check_sharding(dev, tmp: str, weights: str, ckpt: str) -> dict:
    """Phase 17 (b) and (c)'s timer: ConvONet-Opt with its batch over one
    shard of 48 and over [cuda:0, cuda:0], each run timed by PhaseTimer and
    the host clock; the inference eval step split the same way."""
    from if_defense_tpu_torch.cli import inference
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.parallel import best_data_mesh
    from if_defense_tpu_torch.utils.profiling import PhaseTimer

    pc = ellipsoids(np.random.default_rng(0), B)
    timer, host, outs, launches = PhaseTimer(), {}, {}, {}
    split = [dev, dev]
    for tag, devices in (("one shard", None), ("two shards", split)):
        data = save_npz(os.path.join(tmp, f"shard-{tag[:3]}", "x.npz"),
                        {"test_pc": pc, "test_label": np.arange(B) % 40})
        before = all_launches()
        probe = torch.zeros(1, device=dev)
        PhaseTimer.sync(probe)
        t0 = time.perf_counter()
        with timer.phase(tag, probe):
            outs[tag] = support_opt_run(dev, data, weights, devices)
        host[tag] = time.perf_counter() - t0
        launches[tag] = {k: v - before[k] for k, v in all_launches().items()
                         if v - before[k]}
    n_best = best_data_mesh(B, dev.type).size
    a, b = outs["one shard"], outs["two shards"]
    near = float((np.abs(a - b) <= 1e-4).mean())
    summary = timer.summary()
    print(f"  best_data_mesh({B}): {n_best} device(s); one shard of {B} "
          f"{host['one shard']:.3f} s, two shards of {B // 2} on cuda:0 "
          f"{host['two shards']:.3f} s (host clock around opt_defense.main)")
    print(f"  split vs one shard: bit-equal {np.array_equal(a, b)}, "
          f"{near:.6f} of coordinates within 1e-4, max abs diff "
          f"{float(np.abs(a - b).max()):.3e}; launches {launches}")
    if near < 0.999:
        fail(f"the split ConvONet-Opt run holds {near} of coordinates "
             "within 1e-4 of the unsplit one, under 0.999")
    if (launches["two shards"].get("repulsion_loss") != 2 * 402
            or launches["two shards"].get("plane_features") != 2 * 201
            or launches["two shards"].get("plane_features_dp") != 2 * 201):
        fail(f"launches {launches['two shards']} in the split run, not B1 "
             "2 x 402 and B4 2 x (201 + 201)")
    for tag in host:
        gap = abs(summary[tag]["total_s"] - host[tag]) / host[tag]
        print(f"  PhaseTimer {tag}: {summary[tag]['total_s']:.3f} s "
              f"({summary[tag]['count']} phase), host clock "
              f"{host[tag]:.3f} s, {gap:.4f} apart")
        if gap > 0.05:
            fail(f"PhaseTimer's {tag} total is {gap:.3f} off the host clock")

    args = inference.parse_args(["--data", "unused", "--checkpoint", ckpt,
                                 "--batch_size", str(VICTIM_B)])
    clouds = victim_clouds(np.random.default_rng(19), VICTIM_B).to(dev)
    logits = [inference._load_eval_cached(
        args, best_data_mesh(VICTIM_B, devs))[2](clouds)
        for devs in (dev.type, split)]
    same = torch.equal(logits[0].argmax(-1), logits[1].argmax(-1))
    gap = float((logits[0] - logits[1]).abs().max())
    scale = float(logits[0].abs().max())
    print(f"  inference eval step split over [cuda:0, cuda:0]: the same "
          f"predictions {same}, logits bit-equal "
          f"{torch.equal(logits[0], logits[1])}, max abs diff {gap:.3e} "
          f"(bound 1e-5 of the largest, {1e-5 * scale:.3e})")
    if not same:
        fail("the split inference eval step predicts otherwise")
    if gap > 1e-5 * scale:
        fail(f"the split inference eval step's logits are {gap:.3e} off "
             f"the unsplit ones, over 1e-5 of the largest")
    return {"best_data_mesh_devices": n_best, "host_s": host,
            "phase_timer_s": {k: v["total_s"] for k, v in summary.items()},
            "bit_equal": bool(np.array_equal(a, b)), "within_1e-4": near,
            "launches": launches["two shards"]}


def check_trace(dev, weights: str) -> str:
    """Phase 17 (c): `trace` around two reference-mode defense steps; the
    trace file must name B1's and B4's kernels. -> its path."""
    from if_defense_tpu_torch.defense.ifdefense import convonet_opt_defense
    from if_defense_tpu_torch.implicit import ConvOccupancyNetwork
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )
    from if_defense_tpu_torch.utils.profiling import PhaseTimer, trace

    model = ConvOccupancyNetwork()
    model.load_state_dict(params_from_jax(load_params_npz(weights), model))
    defend = convonet_opt_defense(model.to(dev).eval(), iterations=1)
    pc = torch.from_numpy(ellipsoids(np.random.default_rng(3), 4)).to(dev)
    defend(pc, torch.Generator(device=dev).manual_seed(0))      # warm
    logdir = os.path.join(ROOT, "chiprun_out", "support_trace")
    with trace(logdir) as out:
        defend(pc, torch.Generator(device=dev).manual_seed(0))
        PhaseTimer.sync(pc)
    text = open(out["path"]).read()
    found = {k: k in text for k in ("rep_fwd", "rep_bwd", "features_fwd",
                                    "features_dp")}
    print(f"  trace {os.path.relpath(out['path'], ROOT)} "
          f"({os.path.getsize(out['path']) / 2**20:.1f} MiB): {found}")
    if not all(found.values()):
        fail(f"the trace names not every B1 and B4 kernel: {found}")
    return out["path"]


def check_configs(converted: dict) -> str:
    """Phase 17 (d): the shipped configs through `get_model`, each module
    strict-loading its converted weights. -> where the configs came from."""
    from if_defense_tpu_torch.utils.config import get_model, load_config
    from if_defense_tpu_torch.utils.params_io import (
        load_params_npz,
        params_from_jax,
    )

    try:
        import yaml  # noqa: F401
        source = "load_config (PyYAML imports)"
        cfgs = {n: load_config(os.path.join(ROOT, "configs", n),
                               os.path.join(ROOT, "configs", "default.yaml"))
                for n in SHIPPED_CONFIGS}
    except ImportError:
        source = "literal dicts (PyYAML does not import)"
        cfgs = SHIPPED_CONFIGS
    for name, kind in (("convonet_3plane_mn40.yaml", "convonet"),
                       ("onet_mn40.yaml", "onet")):
        model = get_model(cfgs[name])
        model.load_state_dict(params_from_jax(
            load_params_npz(converted[kind]), model), strict=True)
        print(f"  get_model({name}): {type(model).__name__}, "
              f"{sum(p.numel() for p in model.parameters())} weights, "
              "strict-loads the converted weights")
    print(f"  configs from {source}")
    return source


def check_support(dev) -> tuple[dict, dict]:
    """Phase 17: the converters, sharding, profiling and configs on the
    card, under deterministic algorithms (restored on return) but for the
    first ConvONet-Opt run, which runs as the CLI does and must give the
    deterministic run's bits. -> (the numbers printed, the launches of the
    phase)."""
    t0 = time.perf_counter()
    zero_launches()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            seeded, converted, seconds = converted_weights(dev, tmp)
            check_converted(dev, tmp, seeded, converted)
            shards = check_sharding(dev, tmp, converted["convonet"],
                                    converted["pointnet2"])
            trace_path = check_trace(dev, converted["convonet"])
            source = check_configs(converted)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    launches = all_launches()
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return {"conversion_ms": {k: v * 1e3 for k, v in seconds.items()},
            **shards, "trace": os.path.relpath(trace_path, ROOT),
            "configs": source}, launches


def train_counts() -> dict:
    """B5's and B6's launch counters (FPS, ball query)."""
    from if_defense_tpu_torch.ops import cuda_ballquery, cuda_fps

    return {"fps": sum(cuda_fps.launches.values()),
            "ballquery": sum(cuda_ballquery.launches.values())}


def copy_train_state(dst, src) -> None:
    """dst's weights, batch statistics, Adam state and count set to src's
    (a copy: `load_state_dict` keeps tensors of the same device and
    type)."""
    import copy

    dst.model.load_state_dict(src.model.state_dict())
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))
    dst.set_step(src.step)


def split_states(dev, name: str, kw: dict, steps: int, split: list):
    """Two train states of one victim on `dev` from the same
    `flax_init_params(0)` values, with their steps: one shard, and split
    over `split`. -> ((state, step), (state, step))."""
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    weights = params_from_jax(flax_init_params(0, name, **kw),
                              build_model(name, **kw))
    fea = 0.001 if kw else 0.0
    out = []
    for devices in (None, split):
        state = create_train_state(build_model(name, **kw).to(dev),
                                   total_epochs=1, steps_per_epoch=steps)
        state.model.load_state_dict(weights)
        out.append((state, make_train_step(state.model, False, fea,
                                           devices=devices)))
    return out


def hold_split_steps(tag: str, dev, name: str, kw: dict, pc, label,
                     b: int, split: list) -> dict:
    """Phase 18 (a) and (b)'s comparison: len(pc) // b train steps of one
    victim, split over `split` and on one shard, each split step from the
    one-shard run's state with its dropout masks (drawn on the card,
    replayed). Each step: loss rtol TRAIN_LOSS_RTOL, gradients and batch
    statistics by `step_differs`; B5/B6 launches counted over the split
    steps. DGCNN and PointConv replay the one-shard step's kNN graphs in
    the split step (`SplitKnnTap`): the split moves the features' last
    bits, and a near tie of DGCNN's feature-space kNN picks another
    neighbour; the rows whose own graph differs are counted. -> the worst
    figures, those launches and that count."""
    steps = len(pc) // b
    (one, one_step), (two, two_step) = split_states(dev, name, kw, steps,
                                                    split)
    gen = torch.Generator(device=dev).manual_seed(18)
    worst = dict(loss=0.0, cos=1.0, stats=0.0)
    launches = {"fps": 0, "ballquery": 0}
    regraphed_rows = 0
    for i in range(steps):
        copy_train_state(two, one)
        x, y = pc[i * b:(i + 1) * b], label[i * b:(i + 1) * b]
        masks = []
        with KnnTap() as tap:
            _, want = one_step(one, x, y, train_draw(gen, masks))
        replay = iter(masks)
        before = train_counts()
        sizes = [b // len(split)] * len(split)
        with SplitKnnTap(tap.log, sizes) as split_tap:
            _, got = two_step(two, x, y, lambda shape, rate: next(replay))
        torch.cuda.synchronize()
        regraphed_rows += split_tap.changed
        for k, v in train_counts().items():
            launches[k] += v - before[k]
        loss = abs(float(got["loss"]) - float(want["loss"])) / abs(
            float(want["loss"]))
        worst["loss"] = max(worst["loss"], loss)
        if loss > TRAIN_LOSS_RTOL:
            fail(f"{tag} step {i + 1}: loss {float(got['loss'])} split, "
                 f"{float(want['loss'])} on one shard")
        err, cos, stats = step_differs(one.model, two.model)
        if err:
            fail(f"{tag} step {i + 1}, split against one shard: {err}")
        worst["cos"] = min(worst["cos"], cos)
        worst["stats"] = max(worst["stats"], stats)
    print(f"  {tag}: {steps} steps split over {len(split)} shards, loss "
          f"rel {worst['loss']:.2e}, gradient cosine >= "
          f"{worst['cos']:.7f}, batch statistics {worst['stats']:.2e} of "
          f"their scale; B5/B6 launches {launches}; kNN rows of its own "
          f"graph differing {regraphed_rows}")
    return {**worst, "launches": launches, "regraphed_rows": regraphed_rows}


def check_split_small(dev, split: list) -> dict:
    """Phase 18 (a): each of TRAIN_VICTIMS, TRAIN_SMALL_STEPS steps at
    TRAIN_SMALL_B, split in two against one shard."""
    b, steps = TRAIN_SMALL_B, TRAIN_SMALL_STEPS
    pc = victim_clouds(np.random.default_rng(16), b * steps).to(dev)
    label = torch.from_numpy(np.random.default_rng(17).integers(
        0, 40, b * steps)).to(dev)
    out = {}
    for name, kw in TRAIN_VICTIMS:
        tag = name + ("_ft" if kw else "")
        out[tag] = hold_split_steps(tag, dev, name, kw, pc, label, b, split)
        forwards = TRAIN_FORWARD_LAUNCHES[name]
        want = {"fps": steps * len(split) * forwards[0],
                "ballquery": steps * len(split) * forwards[1]}
        if out[tag]["launches"] != want:
            fail(f"B5/B6 launches {out[tag]['launches']} in {tag}'s split "
                 f"steps, not {want}")
    return out


def check_split_full(dev, split: list) -> dict:
    """Phase 18 (b): PointNet++ at batch TRAIN_B, SPLIT_FULL_STEPS steps
    split in two against one shard, then two split runs under
    deterministic algorithms bit-equal, then a split and an unsplit step
    profiled."""
    from if_defense_tpu_torch.models.common import generator_draw

    b, steps = TRAIN_B, SPLIT_FULL_STEPS
    pc = victim_clouds(np.random.default_rng(20), b * steps).to(dev)
    label = (torch.arange(b * steps, device=dev) * 7) % 40
    held = hold_split_steps("pointnet2, full width", dev, "pointnet2", {},
                            pc, label, b, split)
    want = {k: steps * len(split) * v for k, v in zip(
        ("fps", "ballquery"), TRAIN_FORWARD_LAUNCHES["pointnet2"])}
    if held["launches"] != want:
        fail(f"B5/B6 launches {held['launches']} in PointNet++'s split "
             f"steps, not {want} (each shard launches its own)")

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            _, (state, step) = split_states(dev, "pointnet2", {}, steps,
                                            split)
            draw = generator_draw(torch.Generator(device=dev).manual_seed(21))
            losses = [step(state, pc[i * b:(i + 1) * b],
                           label[i * b:(i + 1) * b], draw)[1]["loss"]
                      for i in range(steps)]
            runs.append((torch.stack(losses).cpu(),
                         {k: v.clone() for k, v in
                          state.model.state_dict().items()}))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (la, sa), (lb, sb) = runs
    same = torch.equal(la, lb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    print(f"  two split runs of {steps} steps under deterministic "
          f"algorithms: bit-equal {same}; losses {la.tolist()}")
    if not same:
        fail("two split PointNet++ runs under deterministic algorithms "
             "differ")

    print("  a PointNet++ train step, one shard and split "
          "(tools/profile_train_step.py):")
    prof = tool("profile_train_step")
    times = {"one": prof.profile(dev, "pointnet2", b),
             "split": prof.profile(dev, "pointnet2", b, devices=split)}
    return {"held": held, "deterministic_bit_equal": same,
            "step_ms": {k: {f: v[f] for f in ("wall_ms", "event_ms",
                                              "device_ms", "busy_share")}
                        for k, v in times.items()}}


def check_split_cli(dev, tmp: str, split: list) -> dict:
    """Phase 18 (c): `cli/train.py` on PointNet++ (1 epoch at batch
    TRAIN_B on phase 14's data) through the `devices=` seam, one shard and
    split: the same record fields, train loss within TRAIN_CLI_RTOL
    (accuracies printed); each best checkpoint scored by `cli/inference.py`
    at the accuracy its run recorded, but for near ties. Then the split run
    again from the same seed: its `final.npz` and optimiser sidecar
    bit-equal to the first split run's."""
    from if_defense_tpu_torch.cli import inference, train
    from if_defense_tpu_torch.cli.inference import load_eval_model

    data, _ = train_data(tmp)
    records, seconds, near = {}, {}, {}
    for tag, devices in (("one", [dev]), ("split", split)):
        out = os.path.join(tmp, f"split-cli-{tag}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train.main(["--data", data, "--model", "pointnet2", "--batch_size",
                    str(TRAIN_B), "--epochs", "1", "--output", out,
                    "--registry", os.path.join(out, "registry.json"),
                    "--device", "cuda"], devices=devices)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records[tag] = [json.loads(line) for line in f][0]
        best = os.path.join(out, "best.npz")
        scored = inference.main(["--data", data, "--checkpoint", best,
                                 "--model", "pointnet2", "--normalize",
                                 "--batch_size", str(TRAIN_B), "--device",
                                 "cuda"])
        near[tag] = near_ties(dev, load_eval_model(best, "pointnet2")[0],
                              data)
        differ = round(abs(scored["accuracy"] - records[tag]["test_acc"])
                       * scored["n"])
        print(f"  cli/train.py pointnet2 ({tag}, {len(devices)} shard(s)): "
              f"{seconds[tag]:.2f} s, train_loss "
              f"{records[tag]['train_loss']:.6f}, train_acc "
              f"{records[tag]['train_acc']:.4f}, test_acc "
              f"{records[tag]['test_acc']:.4f}; cli/inference.py on its "
              f"best.npz {scored['accuracy']:.4f} ({near[tag]} near ties)")
        if differ > near[tag]:
            fail(f"scoring the {tag} run's best checkpoint: "
                 f"{scored['accuracy']}, the run recorded "
                 f"{records[tag]['test_acc']}")
    one, two = records["one"], records["split"]
    loss = abs(two["train_loss"] - one["train_loss"]) / one["train_loss"]
    print(f"  split against one shard: train_loss rel {loss:.2e} (bound "
          f"{TRAIN_CLI_RTOL:g}), train_acc {two['train_acc']} / "
          f"{one['train_acc']}, test_acc {two['test_acc']} / "
          f"{one['test_acc']}")
    if set(one) != set(two) or one["epoch"] != two["epoch"]:
        fail(f"the split cli/train.py run's record {two}, the unsplit "
             f"one's {one}")
    if loss > TRAIN_CLI_RTOL:
        fail(f"the split cli/train.py run's train loss {two['train_loss']}"
             f" is {loss:.2e} off the unsplit one's {one['train_loss']}")
    again = os.path.join(tmp, "split-cli-again")
    t0 = time.perf_counter()
    train.main(["--data", data, "--model", "pointnet2", "--batch_size",
                str(TRAIN_B), "--epochs", "1", "--output", again,
                "--registry", os.path.join(again, "registry.json"),
                "--device", "cuda"], devices=split)
    torch.cuda.synchronize()
    seconds["split again"] = time.perf_counter() - t0
    same_final("cli/train.py pointnet2 split over two shards",
               os.path.join(tmp, "split-cli-split"), again)
    return {"seconds": seconds, "train_loss_rel": loss,
            "split_runs_bit_equal": True}


def check_split_training(dev) -> tuple[dict, dict]:
    """Phase 18: sharded victim training over [cuda:0, cuda:0] (two shards,
    two threads), TF32 off; see the module docstring. -> (the numbers
    printed, B5/B6 launches of the phase)."""
    t0 = time.perf_counter()
    zero_launches()
    split = [dev, dev]
    small = check_split_small(dev, split)
    full = check_split_full(dev, split)
    with tempfile.TemporaryDirectory() as tmp:
        cli = check_split_cli(dev, tmp, split)
    from if_defense_tpu_torch.ops import cuda_csr, cuda_gather

    launches = (train_counts() | dict(cuda_gather.launches)
                | dict(cuda_csr.launches))
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s; B5/B6 and "
          f"gather-backward launches {launches}")
    if launches["gather_backward"] <= 0:
        fail("the gather-backward kernel was not launched in split training")
    if launches["csr"] != launches["gather_backward"]:
        fail(f"CSR builds {launches} in split training: not one a gather "
             "backward")
    return {"small": {k: {f: v[f] for f in ("loss", "cos", "stats")}
                      for k, v in small.items()},
            "full": full, "cli": cli}, launches


# phase 19: the accuracy protocol's tool end to end at tiny sizes: 8
# classes x (ACC_TRAIN train, ACC_TEST test) clouds of 1024 points, the
# attacks and defenses of the protocol, few steps each
ACC_TRAIN, ACC_TEST = 8, 4
ACC_ARGV = ["--seeds", "0", "--attacks", "clean", "knn", "perturb",
            "--defenses", "none", "srs", "sor", "dup", "convonet_opt",
            "--opt_modes", "f32", "bf16_r16",
            "--train_per_class", str(ACC_TRAIN),
            "--test_per_class", str(ACC_TEST), "--occ_per_class", "2",
            "--epochs", "2", "--occ_steps", "20", "--defense_iters", "10",
            "--batch_size", "16", "--knn_iter", "10", "--cw_steps", "1", "10",
            "--device", "cuda:0"]


def check_accuracy_tool(dev) -> dict:
    """Phase 19: `tools/accuracy_benchmark_torch.py` end to end on the card
    at tiny sizes (ACC_ARGV), every launch counter set to 0 just before
    and read just after: results.json with the JAX tool's key tree, every
    accuracy a share of the 32 clouds, every leg on cuda:0 with TF32 off,
    and the kernels of the defenses launched (B1 and B4 in ConvONet-Opt's
    reference mode, the scatter-mean and pooled max in its encoder, B5 and
    B6 in DUP-Net). -> (seconds, launches, the table's cells)."""
    acc = tool("accuracy_benchmark_torch")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        summary = acc.main(["--out_dir", tmp, *ACC_ARGV])
        launches = {k: v for k, v in all_launches().items() if v}
        with open(os.path.join(tmp, "seed0", "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(tmp, "seed0", "legs.json")) as f:
            legs = json.load(f)
    seconds = time.perf_counter() - t0
    defenses = {"none", "srs", "sor", "dup", "convonet_opt:f32",
                "convonet_opt:bf16_r16"}
    attacks = results["victims"]["pointnet"]["attacks"]
    records = [r for a in attacks.values()
               for r in (a["attacked"], *a["defended"].values())]
    n = 8 * ACC_TEST
    print(f"  {len(legs)} legs in {seconds:.1f} s; launches {launches}")
    print("  " + ", ".join(f"{k} {v['mean']:.3f}" for k, v in summary.items()))
    if (set(attacks) != {"clean", "knn", "perturb"}
            or any(set(a["defended"]) != defenses for a in attacks.values())
            or any(r["n"] != n or not 0 <= r["accuracy"] <= 1
                   for r in records)):
        fail("the accuracy tool's results.json lacks cells or shares")
    if any(leg["device"] != "cuda:0" or leg["tf32_matmul"]
           or leg["tf32_cudnn"] for leg in legs):
        fail("an accuracy-tool leg ran off cuda:0 or with TF32 on")
    if not all(launches.get(k, 0) > 0 for k in (
            "repulsion_loss", "plane_features", "plane_features_dp",
            "scatter_mean", "pooled_max", "fps", "ballquery")):
        fail(f"the accuracy tool's defenses did not launch every kernel of "
             f"their path: {launches}")
    return {"seconds": seconds, "launches": launches,
            "cells": {k: v["mean"] for k, v in summary.items()}}


# phase 20: the optimiser's three forms, card against a CPU copy
OPT_STEPS = 12


def optimizer_forms(device, grads: dict):
    """Each form of `OptaxAdam` its user builds, on `device`, stepped
    OPT_STEPS times with `grads` (name -> per-step lists of numpy arrays):
    -> name -> (weights, first moments, second moments, rates), numpy."""
    from if_defense_tpu_torch.attack import cw
    from if_defense_tpu_torch.models import build_model
    from if_defense_tpu_torch.optim import OptaxAdam
    from if_defense_tpu_torch.training import create_train_state
    from if_defense_tpu_torch.utils.params_io import (
        flax_init_params,
        params_from_jax,
    )

    rng = np.random.default_rng(20)
    pts = torch.from_numpy(rng.uniform(-.45, .45, (B, N, 3)).astype(
        np.float32)).to(device)
    adv = torch.from_numpy(rng.normal(size=(ATTACK_B, N, 3)).astype(
        np.float32)).to(device).requires_grad_(True)
    model = build_model("pointnet")
    model.load_state_dict(params_from_jax(flax_init_params(0, "pointnet"),
                                          model))
    model.to(device)
    state = create_train_state(model, total_epochs=1, steps_per_epoch=10)
    forms = {"defense": ([pts], OptaxAdam([pts], lr=1e-3), None),
             "cw_adam": ([adv], cw.adam([adv], 1e-3), None),
             "create_train_state": (list(model.parameters()),
                                    state.optimizer, state.scheduler)}
    out = {}
    for name, (params, opt, sched) in forms.items():
        rates = []
        for g in grads[name]:
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a).to(device)
            rates.append(opt.param_groups[0]["lr"])
            opt.step()
            if sched is not None:
                sched.step()
        out[name] = tuple(
            [t.detach().cpu().numpy() for t in ts] for ts in (
                params, [opt.state[p]["exp_avg"] for p in params],
                [opt.state[p]["exp_avg_sq"] for p in params])) + (rates,)
    return out


@contextlib.contextmanager
def reciprocal_division():
    """`torch._foreach_div_(tensors, scalar)` as torch's CUDA kernel
    computes it: a product with the scalar's float32 reciprocal (one
    rounding more than IEEE division, which the CPU's kernel does)."""
    div = torch._foreach_div_

    def by_reciprocal(tensors, other):
        if isinstance(other, float):
            return torch._foreach_mul_(
                tensors, float(np.float32(1) / np.float32(other)))
        return div(tensors, other)

    torch._foreach_div_ = by_reciprocal
    try:
        yield
    finally:
        torch._foreach_div_ = div


def optimizer_operations(dev) -> dict:
    """Each elementwise operation `OptaxAdam` runs, in its form (one
    `torch._foreach_*` call on a list), on the card and on a CPU copy of
    the same float32 inputs (entries over ten decades): -> name -> the
    entries whose bits differ, of 2^20; the division by a scalar also
    against the CPU's product with the float32 reciprocal."""
    rng = np.random.default_rng(22)
    n = 1 << 20
    a = (rng.normal(size=n) * 10.0 ** rng.uniform(-10, 0, n)).astype(
        np.float32)
    b = (np.abs(rng.normal(size=n)) * 10.0 ** rng.uniform(-5, 0, n)
         + 1e-8).astype(np.float32)

    def wide(op):
        def run(t, u):
            w = [t[0].double()]
            op(w, u)
            torch._foreach_copy_(t, w)
        return run

    def by_scalar(t, u):
        torch._foreach_div_(t, 0.0009999871253967285)

    ops = {
        "mul by a scalar": lambda t, u: torch._foreach_mul_(t, 0.9),
        "div by a scalar": by_scalar,
        "mul by a tensor": lambda t, u: torch._foreach_mul_(t, u),
        "div by a tensor": lambda t, u: torch._foreach_div_(t, u),
        "add a scalar": lambda t, u: torch._foreach_add_(t, 1e-8),
        "float64 sqrt, rounded": wide(lambda w, u: torch._foreach_sqrt_(w)),
        "float64 fma, rounded": wide(lambda w, u: (
            torch._foreach_mul_(w, float(np.float32(0.1))),
            torch._foreach_add_(w, [x.double() for x in u]))),
    }

    def run(op, device, name):
        t = [torch.from_numpy(np.abs(a) if "sqrt" in name else a).to(
            device).clone()]
        op(t, [torch.from_numpy(b).to(device)])
        return t[0].cpu().numpy()

    out = {}
    for name, op in ops.items():
        out[name] = int((run(op, dev, name) != run(op, torch.device("cpu"),
                                                  name)).sum())
    with reciprocal_division():
        want = run(by_scalar, torch.device("cpu"), "")
    out["div by a scalar, against the reciprocal product"] = int(
        (run(by_scalar, dev, "") != want).sum())
    return out


def check_optimizer(dev) -> dict:
    """Phase 20: each form of the one optimiser on the card against a CPU
    copy (`optimizer_forms`), and each of its elementwise operations alone
    (`optimizer_operations`). Every operation is the CPU's bits but torch's
    CUDA division of a list by a scalar, a product with the reciprocal
    (`reciprocal_division`): so each form must be bit-equal to a CPU copy
    that divides so, and its gap from the plain CPU copy (IEEE division)
    is printed as a share of the rate times the steps. -> {"operations":
    name -> entries that differ, "gaps": name -> that share}."""
    rng = np.random.default_rng(21)
    from if_defense_tpu_torch.models import build_model

    shapes = {"defense": [(B, N, 3)], "cw_adam": [(ATTACK_B, N, 3)],
              "create_train_state": [tuple(p.shape) for p in
                                     build_model("pointnet").parameters()]}
    grads = {k: [[(rng.normal(size=s) * 10.0 ** rng.uniform(-8, 0, s))
                  .astype(np.float32) for s in v] for _ in range(OPT_STEPS)]
             for k, v in shapes.items()}
    t0 = time.perf_counter()
    operations = optimizer_operations(dev)
    print(f"  each operation, entries of 2^20 whose bits differ from the "
          f"CPU's: {operations}")
    if any(v for k, v in operations.items() if k != "div by a scalar"):
        fail(f"an operation of the optimiser on the card is not the CPU's "
             f"(or the reciprocal product's) bits: {operations}")
    card = optimizer_forms(dev, grads)
    cpu = optimizer_forms(torch.device("cpu"), grads)
    with reciprocal_division():
        emulated = optimizer_forms(torch.device("cpu"), grads)
    gaps = {}
    for name in grads:
        (w, m, v, r), (ew, em, ev, er) = card[name], emulated[name]
        same = r == er and all(
            np.array_equal(a, b) for x, y in ((w, ew), (m, em), (v, ev))
            for a, b in zip(x, y))
        gap = max(float(np.abs(a - b).max()) for a, b in zip(w, cpu[name][0]))
        gaps[name] = gap / (max(r) * OPT_STEPS)
        share = sum(int((a != b).sum()) for a, b in zip(w, cpu[name][0]))
        print(f"  {name}: {len(w)} tensors, {OPT_STEPS} steps; weights, "
              f"moments and rates bit-equal to the CPU copy with the card's "
              f"division {same}; against the plain CPU copy {share} of "
              f"{sum(a.size for a in w)} weights differ, the largest by "
              f"{gap:.3e} ({gaps[name]:.2e} of the rate times the steps); "
              f"last rate {r[-1]!r}")
        if not same:
            fail(f"the optimiser's {name} form on the card is not the bits "
                 "of a CPU copy with the card's division")
    print(f"  phase 20's steps took {time.perf_counter() - t0:.1f} s")
    return {"operations": operations, "gaps": gaps}


def tool(name: str):
    """The module `tools/<name>.py` (a script, not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from if_defense_tpu_torch.data import save_npz
    from if_defense_tpu_torch.ops import (
        _build,
        cuda_csr,
        cuda_gather,
        cuda_interp,
        cuda_repulsion,
        cuda_scatter,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    seconds = {}                     # a phase's seconds, by its number
    current = []

    def phase(n, text=None):
        """Close the running phase (its seconds on a line of their own),
        then open phase `n` and print its title."""
        now = time.perf_counter()
        if current:
            m, t = current.pop()
            seconds[m] = round(now - t, 1)
            print(f"phase {m} took {seconds[m]} s; the script "
                  f"{now - t_start:.1f} s so far", flush=True)
        if n is not None:
            current.append((n, now))
            print(f"phase {n}: {text}", flush=True)
    # files that phase 15 takes from earlier phases: the implicit weights
    # of phase 10, the victims' clouds of phase 12, the perturb output and
    # its PointNet++ checkpoint of phase 13
    keep_dir = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    keep = keep_dir.name
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; card: {card}")

    phase(1, "build")
    t0 = time.perf_counter()
    _build.libraries()
    print(f"  built {sorted(_build.libraries())} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({'cached' if _build.build_info['cached'] else 'nvcc'}) "
          f"into {_build.build_info['dir']}")
    for lib, log in _build.build_info["logs"].items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"  [{lib}] {line.strip()}")

    phase(2, "kernels vs plain versions at the slice's shapes")
    rows = check_kernels(dev)
    print(f"the encoder's scatter-mean kernel (no TPU kernel) at B={B}, "
          f"{SCATTER_N} points, {C} channels:")
    scatter = check_scatter(dev)
    print(f"the encoder's pooled-max kernels (no TPU kernel) at B={B}, "
          f"{SCATTER_N} points, {C} channels:")
    rows.append(check_pooled_max(dev))
    print(f"the CSR build (no TPU kernel) that the gathers' backward and the "
          f"encoder's kernels read, at their shapes:")
    rows.append(check_csr(dev))
    print(f"the gathers' fixed-order backward kernel (no TPU kernel) at the "
          f"victims' training shapes, B={TRAIN_B}:")
    rows.append(check_gather_backward(dev))

    phase(3, "small whole path, CUDA vs CPU, same draws")
    check_small_path(dev)

    phase(4, "ConvONet-Opt through the CLI, full width, 201 steps")
    rates, launches = check_opt_cli()
    print("  a step of the reference mode, profiled "
          "(tools/profile_defense_step.py):")
    step_profiles = [tool("profile_defense_step").profile(dev, v, steps=5)
                     for v in ("convonet", "onet")]

    dup_clouds = ellipsoids(np.random.default_rng(7), DUP_CLOUDS)
    phase(5, "B5/B6 vs plain versions at PU-Net's SA levels, batch "
          f"{DUP_B}")
    rows += check_pointops(dev, dup_clouds[:DUP_B])

    phase(6, "small DUP-Net, CUDA vs CPU, same draws")
    check_small_dupnet(dev)

    phase(7, f"DUP-Net through defend_npz, full width, {DUP_CLOUDS} "
          f"clouds, batch {DUP_B}")
    with tempfile.TemporaryDirectory() as tmp:
        launches["dup"], dup_rates = run_defend_npz(dev, tmp, dup_clouds)
    profile_dupnet(dev, dup_clouds[:DUP_B])

    phase(8, f"B4 with the plane gradient at the training shapes "
          f"(B={TB}, Q={TQ}, {R}x{R}x{C})")
    rows.append(check_plane_features(dev, np.random.default_rng(8), TB, TQ,
                                     train=True))

    train_rates, onet_rates = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        occ_npz = build_occupancy_npz(tmp)
        phase(9, "small training, CUDA vs CPU, same init and batches")
        check_small_training(dev, occ_npz)

        phase(10, f"train_implicit, full width, {TRAIN_STEPS} steps "
              f"at lr {TRAIN_LR:g}")
        for counter in (cuda_interp.launches, cuda_scatter.launches,
                        cuda_csr.launches, cuda_gather.launches):
            for k in counter:
                counter[k] = 0
        runs = {}
        for variant in ("convonet", "onet"):
            for tag in ("first", "warm"):
                runs[variant, tag] = run_train_cli(tmp, occ_npz, variant, tag)
            if variant == "convonet":
                launches["train"] = dict(cuda_interp.launches)
                launches["train_scatter"] = dict(cuda_scatter.launches)
                launches["train_csr"] = dict(cuda_csr.launches,
                                             **cuda_gather.launches)
                print(f"  convonet, both runs: launches {launches['train']}, "
                      f"{launches['train_scatter']}, "
                      f"{launches['train_csr']}")
                want = 2 * TRAIN_STEPS         # one each a step, 2 runs
                # the encoder: the scatter-mean once a plane, the pooled
                # max once a plane in each of 4 blocks, each way
                if launches["train_scatter"] != {
                        "scatter_mean": 3 * want, "pooled_max": 12 * want,
                        "pooled_max_backward": 12 * want}:
                    fail(f"encoder launches {launches['train_scatter']} in "
                         f"ConvONet training, not {3 * want} scatter-mean "
                         f"and {12 * want} pooled max each way")
                # one CSR a plane a step, which its 4 pooled maxes (each
                # way) and its scatter-mean share, and one a gather's
                # backward
                csr = launches["train_csr"]
                if csr["csr"] != 3 * want + csr["gather_backward"]:
                    fail(f"CSR builds {csr} in ConvONet training, not "
                         f"{3 * want} (one a plane a step) plus one a "
                         "gather backward")
                if launches["train"] != {"plane_features": want,
                                         "plane_features_dp": 0,
                                         "plane_features_dplane": want,
                                         "plane_sample": 0,
                                         "plane_sample_duv": 0,
                                         "plane_sample_dplane": 0}:
                    fail(f"B4 launches {launches['train']} in ConvONet "
                         f"training, not {want} forward and {want} plane "
                         "gradient (and no gradient to p)")
        train_rates = {f"{v} {t}": r["steps_per_sec"]
                       for (v, t), r in runs.items()}
        # training repeats its bits from one seed: the CLI runs under
        # deterministic algorithms, and the encoder's scatters are the
        # port's fixed-order kernels
        for variant in ("convonet", "onet"):
            with np.load(runs[variant, "first"]["path"]) as a, np.load(
                    runs[variant, "warm"]["path"]) as b:
                same = a.files == b.files and all(
                    a[k].tobytes() == b[k].tobytes() for k in a.files)
                gap = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
            print(f"  {variant}: the two runs' weights bit-equal "
                  f"{same}, largest gap {gap:.3e}")
            if not same:
                fail(f"two seeded train_implicit --variant {variant} runs "
                     f"differ (largest gap {gap:.3e})")
        for variant in ("convonet", "onet"):
            shutil.copy(runs[variant, "warm"]["path"],
                        os.path.join(keep, f"{variant}.npz"))
        shutil.copy(occ_npz, os.path.join(keep, "occ.npz"))
        profile_training(dev, occ_npz)

        phase(11, "ONet-Opt, small CUDA vs CPU, then opt_defense "
              "--variant onet at full width, 201 steps")
        check_small_onet_opt(dev)
        save_npz(os.path.join(tmp, "onet.npz"),
                 {"test_pc": ellipsoids(np.random.default_rng(0), B),
                  "test_label": np.arange(B) % 40})
        weights = runs["onet", "warm"]["path"]
        for k in cuda_repulsion.launches:
            cuda_repulsion.launches[k] = 0
        onet_rates["first"] = run_cli(tmp, "onet", ["--variant", "onet"],
                                      weights)["clouds_per_sec"]
        launches["onet"] = dict(cuda_repulsion.launches)
        print(f"  onet: launches {launches['onet']}")
        if launches["onet"]["repulsion_loss"] != 2 * 201:
            fail(f"B1 launched {launches['onet']['repulsion_loss']} times "
                 "in ONet-Opt, not 402")
        onet_rates["warm"] = run_cli(tmp, "onet", ["--variant", "onet"],
                                     weights)["clouds_per_sec"]

    phase(12, f"the victims, small CUDA vs CPU, then cli/inference.py "
          f"at full width ({VICTIM_CLOUDS} clouds, batch {VICTIM_B}), a "
          "profile, and B1-B3 at k > 8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_small_victims(dev)
    with tempfile.TemporaryDirectory() as tmp:
        victim_rates, per_victim = run_inference(dev, tmp)
        shutil.copy(os.path.join(tmp, "victims.npz"), keep)
    launches["victims"] = {k: sum(v[k] for v in per_victim.values())
                           for k in ("fps", "ballquery")}
    victim_profiles = profile_victims(dev)
    check_repulsion_any_k(dev)

    phase(13, f"the attacks, small CUDA vs CPU, then cli/attack.py at "
          f"full width (batch {ATTACK_B}), a resumed run, rescoring and a "
          "CW iteration's profile")
    attack_rates, launches["attack"], cw_profile = check_attacks(dev, keep)
    print(f"  B5/B6 and gather-backward launches on the attack path: "
          f"{launches['attack']}")

    phase(14, f"victim training, small CUDA vs CPU, then cli/train.py "
          f"and cli/hybrid_train.py at full width (batch {TRAIN_B}), a "
          "resumed run, scoring and a train step's profile")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fit_rates, launches["fit"], fit_profiles = check_victim_training(dev)
    print(f"  B5/B6 and gather-backward launches on the training path: "
          f"{launches['fit']}")

    phase(15, f"the mesh restoration, small CUDA vs CPU, then "
          f"cli/remesh_defense.py at its defaults (batch {MESH_B}, a "
          f"{32 * 4 + 1}^3 lattice), B4 in estimate_normals and a batch's "
          "profile")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_rates, launches["mesh"], mesh_profiles = check_mesh_path(dev, keep)

    phase(16, "the grid ConvONet and the rest of the implicit library: "
          "B4's uv form, small CUDA vs CPU, training, ConvONet-Opt and the "
          "mesh path on the grid model, PointConvONet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid_rates, grid_launches, uv_row = check_grid_path(
        dev, os.path.join(keep, "occ.npz"))
    launches.update(grid_launches)
    rows.append(uv_row)
    keep_dir.cleanup()

    phase(17, "the support layer: reference .pth converters, "
          "sharding over [cuda:0, cuda:0], PhaseTimer and trace, configs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    support, launches["support"] = check_support(dev)

    phase(18, "sharded victim training over [cuda:0, cuda:0]: small "
          f"steps split against one shard, PointNet++ at batch {TRAIN_B} "
          "split, deterministic reruns and step times, cli/train.py split")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharded, launches["sharded"] = check_split_training(dev)

    phase(19, "the accuracy protocol's tool "
          "(tools/accuracy_benchmark_torch.py) end to end at tiny sizes")
    accuracy = check_accuracy_tool(dev)
    phase(20, "the one optimiser's three forms, 12 steps on the card "
          "against a CPU copy")
    optimizer_gaps = check_optimizer(dev)
    scatter["launches"] = {k: launches[k]["scatter_mean"]
                           for k in ("reference", "fast")}
    scatter["launches"]["accuracy tool"] = accuracy["launches"][
        "scatter_mean"]

    # a row's launches: the counters of its wrapper's launches in its form,
    # summed over the paths that launch it
    used_in = {"repulsion_loss": ("reference grid support",
                                  ("repulsion_loss",)),
               "plane_features": ("reference mesh support",
                                  ("plane_features", "plane_features_dp")),
               "repulsion_mask": ("fast", ("repulsion_mask",)),
               "repulsion_mask_bf16": ("fast", ("repulsion_mask",)),
               "repulsion_loss_masked": ("fast", ("repulsion_loss_masked",)),
               "fps": ("dup victims attack fit pointconv support sharded",
                       ("fps",)),
               "ballquery": ("dup victims attack fit pointconv support "
                             "sharded", ("ballquery",)),
               "plane_sample": ("uv", ("plane_sample", "plane_sample_duv",
                                       "plane_sample_dplane")),
               "plane_features_dplane": ("train", ("plane_features",
                                                   "plane_features_dplane")),
               "pooled_max": ("reference fast train_scatter grid_train",
                              ("pooled_max", "pooled_max_backward")),
               "csr_build": ("reference fast train_csr grid_train attack "
                             "fit sharded", ("csr",)),
               "gather_backward": ("attack fit grid_train sharded",
                                   ("gather_backward",))}
    for row in rows:
        mode, names = used_in[row["name"]]
        row["launches"] = sum(launches[m][n] for m in mode.split()
                              for n in names)
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched in the {mode} mode")
    phase(None)
    print("phase seconds: " + json.dumps(seconds))
    print("clouds/s: " + json.dumps(rates))
    print("defense step profiles: " + json.dumps(step_profiles))
    print("ONet-Opt clouds/s: " + json.dumps(onet_rates) + f" on {card}")
    print("train_implicit steps/s: " + json.dumps(train_rates) + f" on {card}")
    print("DUP-Net clouds/s (defend_npz, host clock around main()): "
          + json.dumps(dup_rates) + f" on {card}")
    print("victims clouds/s (cli/inference.py, host clock around main()): "
          + json.dumps(victim_rates) + f" on {card}")
    print("victim batch profiles: " + json.dumps(victim_profiles))
    print("attacked clouds/s (cli/attack.py, host clock around main()): "
          + json.dumps(attack_rates) + f" on {card}")
    print("CW iteration profile: " + json.dumps(cw_profile))
    print("victim training steps/s (cli/train.py, from metrics.jsonl's "
          "epoch_time, epochs 1 and 2): " + json.dumps(fit_rates)
          + f" on {card}")
    print("victim train step profiles: " + json.dumps(fit_profiles))
    print("mesh restoration clouds/s (cli/remesh_defense.py, metrics "
          "sidecar): " + json.dumps(mesh_rates) + f" on {card}")
    print("remesh batch profiles: " + json.dumps(mesh_profiles))
    print("grid ConvONet and PointConvONet (phase 16): "
          + json.dumps(grid_rates) + f" on {card}")
    print("support layer (phase 17): " + json.dumps(support) + f" on {card}")
    print("sharded victim training (phase 18): " + json.dumps(sharded)
          + f" on {card}")
    print("accuracy tool (phase 19): " + json.dumps(accuracy) + f" on {card}")
    print("the optimiser on the card against the CPU (phase 20: each "
          "operation's entries that differ, each form's largest weight gap "
          "from the plain CPU copy over the rate times the steps): "
          + json.dumps(optimizer_gaps) + f" on {card}")
    print("encoder scatter-mean kernel (csrc/scatter.cu, replaces no TPU "
          "kernel; ms and launches): " + json.dumps(scatter) + f" on {card}")
    pooled = next(r for r in rows if r["name"] == "pooled_max")
    print("encoder pooled-max kernels (csrc/scatter.cu, replace no TPU "
          "kernel; the grid's 32^3 cells, ms): " + json.dumps(pooled["grid"])
          + f" on {card}")
    gather = next(r for r in rows if r["name"] == "gather_backward")
    print("the gathers' backward kernel (csrc/gather.cu, replaces no TPU "
          "kernel; ms at each timed shape): " + json.dumps(gather["shapes"])
          + f" on {card}")
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "source", "replaces", "launches",
                           "max_abs_err", "plain_ms", "call_ms", "device_ms",
                           "library_call_ms", "library_device_ms")}
        | ({"bound_whole_planes_ms": r["bound_whole_ms"]}
           if "bound_whole_ms" in r else {})
        | ({"deterministic_plain_ms": r["deterministic_plain_ms"]}
           if "deterministic_plain_ms" in r else {})
        | {"route": "cuda", "ms": r["device_ms"], "bound_ms": r["bound"][0],
           "launches_per_call": r.get("launches_per_call"),
           "bound_by": r["bound"][1],
           "bound_share": r["bound"][0] / r["device_ms"],
           "library_ms": r["library_device_ms"]}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
