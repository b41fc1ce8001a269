#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile | --path-n | --path-o | --path-p |
                           --path-q | --path-r | --path-s | --path-t |
                           --path-u]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port only (no JAX), and:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from `src/repro_torch/csrc`
     (one nvcc per source, all at once);
  3. drives three paths on `World.synthetic("synth-mnist", nodes=16,
     topology="barabasi_albert", m=2, scale=1.0)` with the paper's MNIST
     MLP 784-512-256-128-10 at full width, each `decdiff+vt` for 3 rounds
     in the default fused mode after one warm round, with every kernel
     launch count set to 0 just before the 3 rounds and read just after:
       a. no transport (the main path of the first slice);
       b. the per-edge transport, `CommConfig(codec="int8",
          policy="adaptive", target_trigger=0.95)` — `gather_rows` must
          launch once per round and the segment reduce at least once;
       c. the per-node transport, `CommConfig(codec="int8")`, always send;
     on each, the VT loss's forward and backward kernels launch once per
     local step; a kernel of a path that was never launched fails the
     run; then two paths of the paper's baselines on the same world,
     each 3 fused rounds after one warm round, the counts set to 0 just
     before and read just after:
       f. `fedavg` (the FED baseline's server average): `neighbor_avg`
          must launch once per round and the segment reduce never; every
          node's params are bitwise equal, and its 16 accuracies equal,
          after each round;
       g. `cfa-ge` (Eq. 9, then the gradient exchange over the directed
          edges): the segment reduce must launch once per round and
          `neighbor_avg` never; params and losses finite;
     then the five paths run again in turns (a, b, c, f, g, g, f, c, b,
     a) for their ms per round; then paths a, b, c and g again with
     `layout="sparse"` (the CSR edge list in width buckets of 8 and 16
     against the dense layout's 10 slots), from the same seed and call
     pattern, whose params, accuracies, train losses, bytes and trigger
     history must be bitwise equal to the dense runs' (the segment reduce
     launches once per bucket and round, `gather_rows` never); and path g
     once more on both layouts with CFA-GE's gradient walk cut into calls
     of 16 edges (the last one holds the rest), bitwise equal too;
  4. checks what comes out: per-node accuracies of shape [16] in [0, 1],
     finite train losses and params, bytes on the wire equal to the
     payload formula (567,438 bytes per fired edge) and a triggered
     fraction in (0, 1]; and a small world run on the card that agrees
     with the same run on the CPU (the plain path, which the CPU tests
     hold against the JAX reference): `decdiff+vt` without and with the
     per-edge transport, `fedavg`, `cfa-ge` and `decdiff+vt` on the
     sparse layout (params to 1e-4, accuracy to one test sample, bytes
     exactly);
  4b. drives path h, the sparse layout at the MLP's full width:
     `World.synthetic("synth-mnist", nodes=256, topology="barabasi_albert",
     m=2, scale=1.0)` (1,016 directed edges, widths 8-64), `decdiff+vt`
     with `layout="sparse"`, the schedule of paths a-c, three runs (no
     transport; the per-edge int8 adaptive 0.95 transport; the per-node
     int8 transport), each with its ms per round, peak device memory,
     launches (the segment reduce once per bucket and round, `gather_rows`
     never, Eq. 5 and the VT kernels as on a-c) and bytes (567,438 B per
     fired edge); a fourth run, `cfa-ge` on the same world and layout,
     with its ms per round, peak memory and the gradient walk's
     row-gradients per round; then the int8 route of one round through the reference's
     entry point `dequant_segment_neighbor_avg`, one call per width bucket
     of the round's [256, 567434] int8 payload (counts set to 0 just
     before, read just after), each bucket against its plain version
     (bitwise) and the fp32 route; and path i, node scale:
     `benchmarks/bench_scale.py:tiny_world` at 10,000 nodes
     (`sparse_barabasi_albert(n=10000, m=2, seed=0)`, 39,964 directed
     edges, max degree 204; MLP 16-32-10), `decdiff` at its engine tier
     (1 local step of batch 4, lr 0.1, loop mode, a warm run then 3
     rounds), without a transport and with the per-edge int8 adaptive 0.6
     transport: rounds per second, triggered fraction, bytes; and
     `cfa-ge` without a transport on the same world and schedule: rounds
     per second and the walk's row-gradients; and, as `bench_scale.py`'s
     dynamics tier (i3), `decdiff` with the per-edge int8 adaptive 0.6
     transport under `EdgeDropout(p=0.2)`: rounds per second, the live and
     triggered fractions and bytes = payload x fired live edges; the dense
     layout is refused at that size;
  4c. drives path j, the paper's Table II / IV path at the Table I CNN's
     full width: `benchmarks/common.py`'s WorldConfig at the paper's 50
     nodes (`World.synthetic("synth-fashion", nodes=50,
     topology="erdos_renyi", p=0.2, seed=0, scale=1.0)`: 60,000 / 10,000
     images, 252 undirected edges, max degree 16; the Fashion CNN,
     1,199,882 params per node), lr 0.1, momentum 0.9, batch 32, 4 local
     steps a round, β = 0.95, and `bench_accuracy.py`'s roster (isol,
     fedavg, dechetero, cfa, cfa-ge, decdiff, decdiff+vt) in the default
     fused mode, as `run_method` builds it.  Cut: 800 rounds to one warm
     round then 3 measured rounds per method, each evaluated on all
     10,000 test images; the counts set to 0 just before the 3 rounds and
     read just after must be exactly the segment reduce once a round on
     the gossip methods, Eq. 5 once a round on decdiff*, the VT loss
     forward and backward once a local step on decdiff+vt, `neighbor_avg`
     once a round on fedavg, and nothing else; it prints ms per round
     (from one round's start to the next's, its evaluation included;
     median of 3), peak device memory and the final accuracy.  Then the
     segment reduce at the round's real [50, 16, 1199882] panel, Eq. 5 at
     [50, 1199882] and `neighbor_avg` at fedavg's real stack, each bitwise
     its plain version, and the VT loss within its tolerance at real
     [1600, 10] logits, all timed as in 6; the Centralized upper bound
     (`centralized_train` as `run_centralized` calls it: lr 0.05, batch
     64; 1 epoch, cut from up to 20); `accuracy_table`,
     `characteristic_time` and `comm_bytes_per_round` over the short
     histories, printed as a 4-round smoke, not the paper's result;
     `synth-emnist` (26 classes, 1,201,946 params, dropout) with
     `decdiff+vt` and `cfa-ge` (keep masks inside the gradient walk) on
     the same world shape, with the VT loss at [1600, 26]; a 6-node
     Fashion CNN world on the card against the CPU (`decdiff+vt`,
     `fedavg`: params to 1e-4, accuracy to one test sample); and the
     bitwise oracles with the CNN on a 16-node world: fused equals loop
     and the sparse layout equals dense (`decdiff+vt`, Fashion), fused
     equals loop with dropout (EMNIST, `decdiff+vt` and `cfa-ge`);
  4d. drives path k, time-varying graphs and the event clock on a-c's
     world, model and schedule (the counts set to 0 just before the 3
     measured rounds and read just after, checked exactly; ms per round,
     peak device memory, live and arrived fractions and simulated seconds
     printed for every run): k0 `StaticGraph()` with the degenerate
     `Timing()`, bitwise equal to path a; k1 `EdgeDropout(p=0.2)` with the
     per-edge int8 adaptive 0.95 transport on both layouts, bitwise equal,
     bytes = payload x fired live edges; k2 `EnergyChurn(8, 4, 4)` under
     `Timing(LognormalStep(1.0, 0.5, seed=7), LognormalLink(...))`
     (bench_time.py's links at 1e6 B/s) for `decdiff+vt` with the per-node
     int8 transport and for `fedavg`: someone dies and rejoins, dead rows
     stay bitwise frozen, `reset_rows` resets the rejoined rows; k3
     `Schedule(deadline=6.0)` with k1's transport and k2's clock: the
     clock reads (r+1)·6 s, some payloads arrive late, fused = loop and
     sparse = dense bitwise; k4 `GilbertElliott(0.1, 0.3)` and
     `PeriodicRewiring(period=1, num_graphs=4)` (the union layout); then
     a small world on the card against the CPU under `ScriptedGraph` and
     under `EnergyChurn` with a deadline;
  4e. drives path l, telemetry (`repro_torch.obs`), right after path k on
     its world and clock, each run a warm round then 5 evaluated rounds
     with the counts set to 0 just before and read just after, checked
     exactly and equal to the same run without telemetry: l0
     `Telemetry(channels="all", ledger=...)` with the per-edge int8
     adaptive 0.95 transport under k3's clock and 6 s deadline, dense,
     fused, run in turns with `telemetry=None` (off, on, off, on): params,
     optimizer and transport state, bytes, trigger, clock and arrival
     histories bitwise the off run's, Σ edge_bytes = bytes_on_wire and
     node_acc = acc_per_node each round, the ledger valid (1 manifest, a
     record per eval round, a summary per run), `export_trace`'s span
     bytes = bytes_on_wire, `run(verbose=True)`'s lines, ms per round on
     and off; l1 l0 on the sparse layout and in loop mode, every round's
     detail bitwise l0's; l2 k2's `EnergyChurn(8, 4, 4)` with the per-node
     int8 transport at a 0.8 trigger (`decdiff+vt`) and `fedavg`, bitwise
     the off runs, a dead node's steps and compute seconds unchanged; a
     `Telemetry(profile_dir=...)` run writing its Chrome traces with
     results bitwise l0's; l3 (inside path h) path h's 256-node sparse
     world with h's per-edge transport and `channels="auto"`, 2 rounds
     each way, peak memory on and off; l4 (inside path i) i1 at 10,000
     nodes with `channels="auto"`, without and with a ledger, rounds per
     second in turns against telemetry=None, and a manifest without
     `edges` (39,964 directed edges exceed MANIFEST_EDGE_CAP); files go to
     `build/path_l/`;
  4f. drives path m, the pod backend (`Experiment(backend="shard_map")`,
     one block of N / P nodes per `torch.distributed` rank), right after
     path l on a-c's world under `EdgeDropout(p=0.2)`, k's clock with its
     6 s deadline and every channel, each run a warm round then 3 fused
     rounds with the counts set to 0 just before and read just after: m0
     in this process over NCCL at world size 1, `decdiff+vt` with the
     per-edge int8 adaptive 0.95 transport on both layouts, bitwise the
     vmap run (params, optimizer and transport state, every history and
     channel, the loss) with the same launches, ms per round beside
     path a's and the gather's share; m1 two gloo ranks on the one card
     (`torch.multiprocessing.spawn`, both on cuda:0, the gather staged
     through host memory) running m0's two runs, `fedavg` and `cfa-ge`,
     each bitwise the vmap run in this process (the loss, a mean of the
     pods' means, within 1e-6) with each rank's launches the vmap run's,
     ms per round and the gather's ms a round; m2 in the same two ranks,
     path d's round (its init, batches and its 3 measured rounds, each
     timed) at two pods of two nodes: the fused int8 gossip gathers q
     [4, D] and the scales and runs `dequant_neighbor_avg_rows` on [2, 4]
     weights, each node's params bitwise path d's (sha256) and the
     losses within 1e-5; the kernels held against their plain versions at
     the block shapes (the segment reduce on pod 0's [8, 10, 567434]
     panel, the gather on its 80 rows, Eq. 5 on [8, 567434], the drift
     norms on its 80 per-edge rows, the VT loss at [256, 10],
     `dequant_neighbor_avg_rows` at [2, 4, 463987712]);
     rendezvous files and results go to `build/path_m/`;
  5. drives path d, the LM DFL pod round: `build_dfl_round_shardmap` in
     its one-pod form with the fused int8 gossip
     (`Int8Codec(stochastic=False)`), `build_lm(get_config("qwen1.5-0.5b"))`
     at full width (463,987,712 bf16 params per node), a 4-node ring,
     `sgd_momentum(lr=3e-3, momentum=0.9)`, the VT loss (β = 0.98), batch
     4 and seq 128 from `synthetic_token_batch`: one warm round, then 3
     measured rounds with the counts set to 0 just before and read just
     after — `dequant_neighbor_avg_rows` must launch once per round and the
     VT loss's forward and backward once per node-step; it prints ms per
     round, the peak device memory and the (finite) losses; then a reduced
     fp32 round (2 layers, d_model 64, vocab 256, 4 nodes, 2 rounds) on the
     card agrees with the CPU (params to 1e-4, loss to 1e-5);
  6. holds each kernel against its plain PyTorch version on the card at
     the main paths' shapes (and more), and times kernel, plain version and
     one PyTorch library call two ways beside the bound: `ms` (CUDA events
     around one call, median of 20, the Python launcher included) and, for
     the kernel and the library call, `kernel_ms` / `library_kernel_ms`
     (their device kernels alone: torch.profiler over 20 calls, the sum of
     the device events over 20); at paths a-c's and f's shapes also with
     the L2 cold (128 MB written before each call, outside what is timed:
     `*_cold`).  The segment reduce and the gather bitwise at paths a and
     b's shapes and at a 64-node BA m=2 shape; `neighbor_avg` (one launch,
     the weights' normalization inside it: one device kernel a call in the
     profiler) bitwise on path f's real stack [16, 567434] with its |D_i|
     weights, on path d's flat block [4, 463987712] with receiver 0's ring
     weights and at an odd N = 10, D = 1,000,003 with one zero weight (the
     whole call against `torch.mv(x.t(), w / w.sum())`, its device time
     against the gemv alone);
     `dequant_neighbor_avg_rows`
     bitwise on path d's real int8 payload [4, 463987712] and at an odd D
     with 8 receivers and one zero row; `dequant_segment_neighbor_avg`
     bitwise at path c's per-node panel [16, 10, 567434] of the round's
     int8 payloads; `dequant_neighbor_avg` bitwise on path d's int8 block
     with receiver 0's weights (and equal to row 0 of
     `dequant_neighbor_avg_rows`), after the int8 route of path d's
     gossip one receiver at a time through it (4 launches, counted);
     the Eq. 5 kernels on path d's real
     flat block [4, 463987712] and its neighbourhood average (pass B
     bitwise for the kernel's scale, the norms within a stated tolerance);
     the VT loss forward and backward within a stated tolerance on path
     d's real logits [512, 151936] (bf16 and fp32) and at the MLP's
     [512, 10] and [32, 10]; the transports' drift norms (Eq. 5's pass A
     and scale kernel) within a stated tolerance, and a block of rows
     bitwise the full call's, on path b's real per-edge rows and path c's
     per-node rows;
  7. drives path e, dense serving at full width, after path d's state is
     freed: the reference's `decode_32k` serve step (`launch/dryrun.py`)
     with the request flow of `examples/serve_decode.py`, through
     `launch/serve.py:generate` — `build_lm(get_config("qwen1.5-0.5b"))`
     (463,987,712 bf16 params drawn on the card), `lm.init_cache(8, 32768)`
     (25.8 GB of bf16 k and v; the batch cut from 128 to 8) with its ring
     filled to a near-full 32k context (N(0, 1) k and v at positions
     0..32719, in place of a prefill's), 16 prompt tokens per sequence
     through `build_serve_step`, then 32 greedy decode steps, which fill
     the last slots, with the counts set to 0 just before and read just
     after: `decode_attention_fused` must launch 24 x 48 times.  It prints
     ms per decode step (median of 32, min and max), tokens per second,
     the peak device memory and the first sequence's tokens; checks finite
     logits of shape [8, 1, 151936], the ring's slot positions (0..32767)
     and length; and a
     reduced decode (fp32, qwen1.5-0.5b and qwen3-32b's G = 8) on the card
     agrees with the CPU (logits 1e-4, equal tokens) and with the port's
     teacher-forced forward on the card (1e-4).  Then the decode kernel
     against its plain version (a stated tolerance) on path e's real
     layer-0 cache with a real query, a full synthetic window [8, 32768,
     16, 64] bf16, qwen2.5-14b's GQA shape (q [8, 40, 128], k / v [8,
     32768, 8, 128]) with fp32 and with bf16 queries, qwen3-32b's G = 8,
     hd 128 over the full 32,768 slots, an odd B = 3, W = 1000 with a
     sliding window, a W below one tile (40), a W one slot past a tile
     boundary (4097) and a ring with no live slot (the uniform average);
  7b. drives path n, the five LM families beside the dense one at their
     registered widths (bf16; depth cut only where 80 GB forces it, each
     cut printed), each sub-path with its peak memory, ms per forward,
     train step and decode step, and seconds: n1 llava-next-mistral-7b
     (all 32 layers; forward + VT loss at 1 x (2880 image + 128 text);
     the train step at the depth whose params, grads and fp32 momentum
     fit 48 GB: 26 layers); n2 mixtral-8x7b at 8 of 32 layers (forward +
     loss at 2 x 512 under the global and the batch_local dispatch; a
     train step at 2 layers; decode over its 4,096-slot sliding-window
     ring filled so that it has wrapped); n3 arctic-480b at 1 of 35 layers
     (27 GB; forward and decode, G = 7); n4 mamba2-2.7b (all 64 layers;
     forward at 2 x 2048, a train step, 48 decode steps, the decode
     state's bytes at two seq_lens, equal); n5 zamba2-2.7b (all 54 layers;
     forward at 2 x 2048, a train step, decode through B.9 at hd 80 over
     six group rings); n6 whisper-large-v3 (32 + 32 layers;
     `prep_decode_cache` on 8 x 1500 frames, forward + VT loss over 448
     decoder tokens at V = 51,866, decode); n7 one fused int8 pod round
     of mixtral on a 2-node ring at the depth whose 20 B a param fit 72 GB
     (1 layer), the router aux in each node's loss.  Every decode of n1-n6
     is held against the teacher-forced forward at position 15 of 2 x 16
     tokens with fp32 activations over the same bf16 weights (within 1e-3
     of the largest logit; the bf16 gap is printed: the two paths round
     in different places, and the reference's own bf16 gap passes 2e-2
     at 8 mamba2 layers: tests/test_torch_families.py); MoE's check at a
     capacity that drops nothing, as the reference's oracle.  Launches
     are checked exactly: the VT loss once a loss and once forward and
     backward a train step, `decode_attention_fused` once per attention
     layer and decode step.
     Then each family's reduced preset (fp32) on the card against the
     CPU (logits 1e-4, loss and aux 1e-5, 8 decode steps 1e-4 with equal
     tokens), B.9 against its plain version on path n's real rings
     (mixtral's window, arctic's G = 7, zamba2's hd 80, whisper's K = 20)
     and B.3 on its real logits at V = 32,000, 50,280 and 51,866 (not a
     multiple of 8: 4-byte vectors); `--path-n` runs the
     kernel build and path n alone;
  7c. drives path o, checkpoints and the dry run, after path n: o1
     `repro_torch.launch.train.run` at full width (`--arch qwen1.5-0.5b
     --preset full --nodes 2 --steps 3 --batch 4 --seq 128 --ckpt-dir`
     under `build/path_o/`, after checking the disk's free space: 2 x
     463,987,712 bf16 params and fp32 momentum, ~5.6 GB), the VT loss
     forward and backward once per node-step and Eq. 5 once per round;
     the manifest's keys, shapes and dtypes equal the state's, bf16 leaves
     "bfloat16" under the npy header '<V2'; o2 `restore_checkpoint` onto
     the card, every leaf bitwise (sha256) the state o1 ended with, and
     one more DFL round from the restored state bitwise the same round
     from the in-memory state; o3 8 greedy tokens of 4 sequences from node
     0's restored params through `launch/serve.py:generate` (B.9 24 times
     a step), bitwise the same decode from the in-memory params; o4 the
     dry run (`python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b`,
     one process per shape and mesh at nice 19, started before path n
     and run on the host's cores beside paths n and o; with `--path-o`,
     started with o1), every shape on both meshes `ok`, with FLOPs per
     chip,
     argument and temp bytes per device and `fits_hbm` printed; the
     checkpoint's GB and its write and read seconds; launches counted
     from 0 around o1, o2's restored round and o3's restored decode, and
     checked exactly; `--path-o` runs the kernel build and path o alone;
  7d. drives path p, the examples (`examples_torch/`), after path o: each
     example's `main(argv)` at the reference example's defaults on the
     card, every launch count set to 0 just before each and read just
     after, and checked exactly: quickstart (16 ER nodes, 30 rounds,
     `isol` and `decdiff+vt`), compressed_gossip (the six transports of
     the 8-node BA smoke world, 15 rounds each; the always-send fp32,
     bf16, int8 and top-k rows carry payload x directed edges x rounds
     bytes, the int8 reduction column reads the payload ratio),
     decentralized_mnist (20 nodes, 60 rounds, Centralized and the 7
     Table II methods; eight finite Table II rows with accuracy in [0, 1],
     Table IV recomputed from the same histories), multipod_dfl_train (8
     ring nodes, 20 rounds, one NCCL rank in this process and then two
     gloo ranks sharing the card, bitwise the one-rank run, the
     node0-node1 distance shrinking) and serve_decode (its default arch);
     every printed line in the reference example's format; then, at a
     reduced size, quickstart's two methods, the six transports (int8
     deterministic) and two of decentralized_mnist's methods on the card
     against the CPU (params 1e-6 without a transport, 1e-4 plus one
     codec grain with one, accuracy within one test sample, bytes and
     triggers exact); each example's wall seconds and ms per round;
     `--path-p` runs the kernel build and path p alone;
  7e. drives path q, the partitioned dense LM step (`build_train_step`,
     `build_prefill_step` and `build_serve_step` with `mesh=`: params,
     optimizer state, batch and cache placed as DTensors by the specs),
     after path p, at full qwen1.5-0.5b width (bf16 params): one train
     step of 4 x 128 (VT loss, β = 0.98), prefill of the same batch and
     32 greedy decode steps on a 4,096-slot ring, with fp32 activations:
     q0 unpartitioned, then on a (data, model) = (1, 1) mesh over NCCL in
     this process, bitwise equal (loss, updated params, prefill logits,
     every decode step's logits and tokens, launches); q1 on a (1, 2)
     mesh in two ranks sharing the card (`torch.multiprocessing.spawn`,
     both on cuda:0) over the host-staged backend
     (`repro_torch.dist.host_staging`: gloo's functional all-gather of
     CUDA tensors ends the process there, so every collective runs on
     host copies through gloo), held to the unpartitioned step (loss
     within 1e-5, logits within 1e-3 of the largest, equal tokens), each
     rank's launches checked exactly: the vocab-parallel VT kernels
     (`vt_kl_partial_fwd`, `vt_kl_shard_bwd`) once each, the split-hd
     decode kernels (`decode_scores_partial`, `decode_softmax_combine`)
     4 x 32 times (4 of the 24 layers: the script's time limit); then
     the same steps with bf16 activations timed both ways (ms per train,
     prefill and decode step, medians); then, in this
     process, B.3's split forms at [512, 151936] (fp32 and bf16) and
     B.9's at path e's [8, 32768, 16, 64] bf16 cache and at qwen3-32b's
     GQA cache [8, 32768, 8, 128], each at 2 and 16 shards, against their
     plain versions, bitwise across batch sizes (a row alone = that row
     of the batch) and calls, and timed against the byte bound (the
     16-shard shapes also with the L2 cold; B.9's scores beside one
     `torch.matmul`), and B.9's again at q1's own [4, 4096, 16, 64] cache
     cut in 2, fp32 and bf16, against their plain versions, and B.3's
     split forms at two many-row shapes, [4096, 51866] over 2 shards and
     [4096, 151936] over 16; files go to
     `build/path_q/`; `--path-q` runs the kernel build and path q alone,
     `--path-q-decode` the kernel build and B.9's split kernels alone,
     `--vt-split` the kernel build and B.3's split kernels alone at every
     path's shard shape and the two many-row ones, fp32 and bf16, then
     their bitwise checks;
     then path r, the LM DFL round partitioned inside each pod on the
     multi mesh (pod, data, model): full-width qwen1.5-0.5b cut to 2 of
     its 24 layers (the script's time limit), two nodes on a ring, each with a batch of 4 x 128 (VT loss), fp32 params and
     activations for the checks; r0 the unpartitioned round of each
     exchange (fp32, the bf16 cast, the deterministic int8 codec), then
     the same on a (1, 1, 1) mesh over NCCL in this process, bitwise
     equal (loss and gossiped params; int8 against the one-pod fused
     `build_dfl_round_shardmap`) with equal launches; r1 on a (2, 1, 2)
     mesh in four ranks sharing the card over the host-staged backend,
     each exchange held to the unpartitioned round shard for shard (loss
     within 1e-5, params within 1e-5, int8 within 1e-4 plus one int8
     grain), then prefill and 32 decode steps on a 4,096-slot ring held
     to the unpartitioned steps (logits within 1e-3 of the largest, equal
     tokens), each rank's launches checked exactly (`vt_kl_partial_fwd`,
     `vt_kl_shard_bwd` and `decdiff_update` once a round,
     `dequant_neighbor_avg_rows` once in the int8 round, the split-hd
     decode kernels 12 x 32 times); the bf16 round (registered bf16
     config, bf16 exchange) timed both ways; then the split B.2
     (`ops.decdiff_rows_split`) at r1's flat block against its plain
     version, timed against its byte bound; files go to `build/path_r/`
     (~11 GB of references, deleted at the end); `--path-r` runs the
     kernel build and path r alone;
     then path s, the partitioned MoE step (ROADMAP A.14.2), each cut
     printed: s0, full-width mixtral-8x7b cut to 1 of 32 layers in fp32,
     per dispatch mode ("global", `moelocal`, `expertpar`) a train step
     of 4 x 128, prefill and 32 decode steps on a 4,096-slot ring,
     unpartitioned, then on a (1, 1) NCCL mesh, bitwise (loss, params,
     logits, tokens, expert choices and kept assignments) with equal
     launches; s1, the same on a (1, 2) mesh of two ranks sharing the card
     over the host-staged backend, each against the unpartitioned run
     kept in this process (the ranks' param shards compared over CUDA
     IPC): loss and params within 1e-5 shard for shard, logits within
     1e-3 of the largest, equal tokens and expert choices, launches exact
     a rank; arctic-480b cut to 1 of 35 layers (bf16 params, fp32
     activations; no train step: one layer's params, grads and momentum
     exceed the card), prefill and 32 decode steps, "global" and
     `expertpar`, within 2e-2 of the largest logit with equal tokens and
     choices; the bf16 mixtral train step timed both ways; s2, a (2, 1,
     2) mesh of four host-staged ranks, one DFL round of two `expertpar`
     mixtral nodes (1 layer, fp32) per exchange (the bf16 cast, the
     deterministic int8 codec; the fp32 exchange's gathered models do not
     fit four ranks on the card) against the unpartitioned round, whose
     params wait on the host, shard for shard within 1e-5 (int8: 1e-4
     plus one grain), the loss within 1e-5, launches exact; then B.3's split forms at V = 32000
     over two shards and B.9's at mixtral's (G = 4) and arctic's (G = 7)
     [4, 4096, 8, 128] caches cut in two, fp32 and bf16, against their
     plain versions and timed, and the split B.2 at s2's flat block;
     `--path-s` runs the kernel build and path s alone;
     then path t, the partitioned SSM and hybrid steps (ROADMAP A.14.3),
     each cut printed: t0, full-width mamba2-2.7b cut to 2 of 64 layers
     and zamba2-2.7b to 18 of 54 (two groups of 9: the shared block
     invoked twice, two rings), fp32, a train step of 2 x 512 (two SSD
     chunks of 256, so the carried state is exercised), prefill and 32
     decode steps on a 4,096-slot ring, unpartitioned, then on a (1, 1)
     NCCL mesh, bitwise (loss, params, logits, tokens) with equal
     launches; t1, the same on a (1, 2) mesh of two host-staged ranks
     against the unpartitioned run (params within 1e-5 shard for shard,
     the loss within 1e-5, logits within 1e-3 of the largest, equal
     tokens, launches exact a rank: the vocab-parallel B.3 once each way,
     zamba2's split B.9 twice a decode step); mamba2's bf16 train step
     timed both ways; t2, a (2, 1, 2) mesh of four host-staged ranks, one DFL
     round of two mamba2 nodes (2 layers, fp32) per exchange (bf16, the
     deterministic int8 codec) against the unpartitioned round, as s2;
     then B.3's split forms at [1024, 50280] and [1024, 32000] over two
     shards, B.9's at zamba2's [2, 4096, 32, 80] ring cut in two (hd 40
     a shard, G = 1), fp32 and bf16, and the split B.2 at t2's flat
     block, against their plain versions and timed; `--path-t` runs the
     kernel build and path t alone;
     then path u, the partitioned enc-dec and VLM steps (ROADMAP
     A.14.4), each cut printed: u0, full-width whisper-large-v3 cut to 2
     + 2 of 32 + 32 layers (a train step of 2 x 448 decoder tokens after
     1500 encoder frames, prefill, the cross caches through
     `build_prep_cache_step`, 32 decode steps on a 448-slot ring) and
     llava-next-mistral-7b cut to 2 of 32 (2 x 128 text tokens after its
     2880 image tokens, 32 decode steps on a 4,096-slot ring), fp32,
     unpartitioned, then on a (1, 1) NCCL mesh, bitwise (loss, params,
     logits, cross caches, tokens) with equal launches; u1, the same on a
     (1, 2) mesh of two host-staged ranks against the unpartitioned run
     (as t1; launches exact a rank: the vocab-parallel B.3 once each way,
     the split B.9 twice a whisper decoder layer and step (its ring and
     its cross caches, read in place) and once a llava layer and step);
     whisper's bf16 train step timed both ways; u2, a (2, 1, 2) mesh of four
     host-staged ranks, one DFL round of two whisper nodes (2 + 2 layers,
     fp32, the batch carrying `enc_embeds`) per exchange (bf16, the
     deterministic int8 codec) against the unpartitioned round, as s2;
     then B.3's split forms at [896, 51866] (25933 columns a shard) and
     [256, 32000] over two shards, B.9's at whisper's ring [2, 448, 20,
     64] and cross cache [2, 1500, 20, 64] (every slot live) and llava's
     [2, 4096, 8, 128] ring, each cut in two, fp32 and bf16, and the split
     B.2 at u2's flat block, against their plain versions and timed;
     `--path-u` runs the kernel build and path u alone;
  8. prints one JSON line listing the kernels, then the card's name and
     power limit, then, as its last line, `{"ok": true, "device": {...}}`.

Paths a-d, h and i also run the Eq. 5 step through the `decdiff_update`
kernels: one launch per round each; every run with a transport computes
its drift through `drift_norms` once a round.  With `--profile` it also traces one
more round (eval included) of paths a, b, g, h (without a transport and
per-edge, and cfa-ge), i (every run) and j (decdiff+vt), one round of path
d and one decode step of path e under `torch.profiler` and prints the
device time by kernel and the device's busy share of the wall time.

Any failure exits non-zero before the last line is printed.  Without a
CUDA card, or without the port beside this script, it exits 2.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
ROUNDS = 3
REPS = 20
LM_ARCH = "qwen1.5-0.5b"
LM_PARAMS = 463_987_712     # per node, bf16
LM_NODES, LM_BATCH, LM_SEQ, LM_BETA = 4, 4, 128, 0.98
SERVE_BATCH, SERVE_WINDOW, SERVE_PROMPT, SERVE_STEPS = 8, 32768, 16, 32
LM_LAYERS = 24
Q_LAYERS = 4                # path q's cut: the whole script's time limit
H_NODES = 256               # path h: the sparse layout at full MLP width
I_NODES = 10_000            # path i: bench_scale.py's tiny world
# path j: benchmarks/common.py's WorldConfig at the paper's 50 nodes, and
# bench_accuracy.py's Table II roster
J_NODES = 50
J_METHODS = ("isol", "fedavg", "dechetero", "cfa", "cfa-ge", "decdiff",
             "decdiff+vt")
J_TRAIN = dict(steps_per_round=4, batch_size=32, lr=0.1, momentum=0.9,
               beta=0.95, seed=0)
J_PARAMS = {10: 1_199_882, 26: 1_201_946}  # the Table I CNN, by classes


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps=REPS, before=None):
    """Median over `reps` single calls, each bracketed by CUDA events (the
    call's host launcher included); `before` runs ahead of each call,
    outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(torch, fn, reps=REPS, before=None):
    """CUDA events around `reps` back-to-back calls, over `reps` (with
    `before`, the median of single calls instead): the device's time per
    call wherever the device, not the launcher, is the slower side."""
    if before is not None:
        return median_ms(torch, fn, reps, before)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps=REPS, before=None):
    """The device time of `fn`'s kernels alone, under torch.profiler over
    `reps` calls (memory copies and sets, which `before` may make, left
    out): for each kernel name, its mean duration over the events the
    profiler recorded times its launches per call (recorded events over
    `reps`, rounded; at least 1), summed over the names.  The profiler
    can miss some of a long kernel's events (it recorded 14 of 20 calls of
    a 3 ms kernel on the card), so the mean of what it saw stands in for
    the missed ones.  Late in a long run it recorded fewer calls per
    session and, once, none: then the time comes from `batch_ms` (CUDA
    events) and the kernel count and names are None.  Returns (ms per
    call, kernels per call, recorded events over `reps`, their names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith(("Memcpy", "Memset")):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        print("  (the profiler recorded no device kernel: device ms from "
              "CUDA events around back-to-back calls)")
        return batch_ms(torch, fn, reps, before), None, 0.0, None
    per_call = {n: max(1, round(len(us) / reps)) for n, us in by_name.items()}
    total_us = sum(statistics.fmean(us) * per_call[n]
                   for n, us in by_name.items())
    return (total_us / 1e3, sum(per_call.values()),
            sum(len(us) for us in by_name.values()) / reps,
            sorted(n[:60] for n in by_name))


def l2_flush(torch):
    """A call that writes 128 MB (one device-to-device copy: a memcpy in the
    profiler, apart from the kernels), so that what follows finds none of
    its inputs in the 50 MB L2."""
    src = torch.empty((32 << 20,), dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def timings(torch, kernel, plain, library, cold=False, library_device=None):
    """Kernel, plain version and library call timed two ways.  `ms`,
    `plain_ms`, `library_ms`: CUDA events around one call, median of
    REPS (the host launcher included).  `kernel_ms`, `library_kernel_ms`:
    their device kernels alone (`device_ms`; `library_device`, when given,
    is the library call whose kernels are timed).  With `cold`, the same
    for kernel and library with 128 MB written before each call, outside
    what is timed (`*_cold`).  `library` None (no PyTorch call computes
    the function): `library_ms` None and no library timing."""
    lib_dev = library if library_device is None else library_device
    t = dict(ms=median_ms(torch, kernel), plain_ms=median_ms(torch, plain),
             library_ms=None if library is None
             else median_ms(torch, library))
    (t["kernel_ms"], t["kernels_per_call"], t["kernel_events_per_call"],
     t["kernel_names"]) = device_ms(torch, kernel)
    if library is not None:
        t["library_kernel_ms"], _, _, t["library_kernels"] = device_ms(
            torch, lib_dev)
    if cold:
        flush = l2_flush(torch)
        t["ms_cold"] = median_ms(torch, kernel, before=flush)
        t["kernel_ms_cold"] = device_ms(torch, kernel, before=flush)[0]
        if library is not None:
            t["library_ms_cold"] = median_ms(torch, library, before=flush)
            t["library_kernel_ms_cold"] = device_ms(torch, lib_dev,
                                                    before=flush)[0]
        del flush
        torch.cuda.empty_cache()
    return t


def timing_text(t, lib_name, bound_ms):
    """One line of `timings`' numbers beside the bound."""
    count = ("CUDA events" if t["kernels_per_call"] is None else
             f"{t['kernels_per_call']:g} kernels a call")
    text = (f"kernel {t['ms']:.4f} ms call / {t['kernel_ms']:.4f} ms device "
            f"({count}, {t['kernel_events_per_call']:g} recorded), plain "
            f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms "
            f"call / {t['library_kernel_ms']:.4f} ms device, kernel device "
            f"time at {100 * bound_ms / t['kernel_ms']:.1f}% of bound")
    if "kernel_ms_cold" in t:
        text += (f"; L2 cold: kernel {t['ms_cold']:.4f} / "
                 f"{t['kernel_ms_cold']:.4f} ms, {lib_name} "
                 f"{t['library_ms_cold']:.4f} / "
                 f"{t['library_kernel_ms_cold']:.4f} ms (call / device)")
    return text


def segment_bound_ms(b, k, d):
    """Least time for the reduce: each input read once, each output
    written once, over HBM bandwidth; or its fp32 flops over the peak."""
    nbytes = 4 * (b * k * d + b * k + b * d + b)
    flops = 2 * b * k * d + b * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def kernel_vs_plain(torch, ops, plain, vals, w, label, cold=False):
    """Hold the kernel against its plain version and time kernel, plain
    version and `torch.einsum("bk,bkd->bd", w, vals)` (`timings`)."""
    b, k, d = vals.shape
    sums, tot = ops.segment_neighbor_avg(vals, w)
    torch.cuda.synchronize()
    ps, pt = plain(vals, w)
    equal = bool(torch.equal(sums, ps) and torch.equal(tot, pt))
    err = max(float((sums - ps).abs().max()), float((tot - pt).abs().max()))
    t = timings(torch, lambda: ops.segment_neighbor_avg(vals, w),
                lambda: plain(vals, w),
                lambda: torch.einsum("bk,bkd->bd", w, vals), cold=cold)
    bound_ms, bound_by = segment_bound_ms(b, k, d)
    print(f"segment_neighbor_avg {label} [B={b}, K={k}, D={d}]: "
          f"torch.equal(kernel, plain)={equal} max_abs_err={err:g} "
          f"{timing_text(t, 'einsum', bound_ms)}; bound {bound_ms:.4f} ms "
          f"({bound_by})")
    check(equal, f"segment_neighbor_avg {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    return dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[b, k, d])


def navg_vs_plain(torch, ops, x, weights, label, cold=False):
    """Hold `ops.neighbor_avg` (one launch: the weights' ordered sum and
    IEEE division inside the kernel) against its plain version (bitwise)
    on x [N, D] with raw weights, and check that the profiler sees one
    device kernel a call.  Times: the whole `ops.neighbor_avg` call, the
    plain version, and `torch.mv(x.t(), w / w.sum())` as one call; device
    time: the kernel against `torch.mv(x.t(), wn)`'s gemv alone (the port
    never calls either).  Bound: x and w read once, the [D] average written
    once, over HBM bandwidth; or 2·N·D fp32 flops over the fp32 peak."""
    from repro_torch.kernels import neighbor_avg as na

    n, d = x.shape
    out = ops.neighbor_avg(x, weights)
    torch.cuda.synchronize()
    ref = na.neighbor_avg_plain(x, weights, normalize=True)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    zeros = int((weights == 0).sum())
    del out, ref
    wn = (weights / weights.sum()).contiguous()
    t = timings(torch, lambda: ops.neighbor_avg(x, weights),
                lambda: na.neighbor_avg_plain(x, weights, normalize=True),
                lambda: torch.mv(x.t(), weights / weights.sum()), cold=cold,
                library_device=lambda: torch.mv(x.t(), wn))
    nbytes = 4 * ((n + 1) * d + n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * n * d / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"neighbor_avg {label} [N={n}, D={d}, {zeros} zero weights]: "
          f"torch.equal(kernel, plain)={equal} max_abs_err={err:g} "
          f"{timing_text(t, 'torch.mv', bound_ms)} (the library call with "
          f"w / w.sum(), its device time torch.mv's alone: "
          f"{t['library_kernels']}); bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e9:.4f} GB)")
    check(equal, f"neighbor_avg {label}: kernel != plain (max_abs_err "
                 f"{err:g})")
    # one device kernel a call, wherever the profiler recorded the calls
    # (tests/test_torch_cuda.py holds it too)
    check(t["kernels_per_call"] is None or (
        t["kernels_per_call"] == 1 and t["kernel_events_per_call"] <= 1
        and all("neighbor_avg_kernel" in k for k in t["kernel_names"])),
          f"neighbor_avg {label}: {t['kernel_events_per_call']} device "
          f"kernels a call ({t['kernel_names']}), not 1")
    return dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[n, d])


def gather_bound_ms(tbl_rows, idx, d):
    """Least time for the gather: the distinct rows the index names read
    once, every output row written once, the indices read once, over HBM
    bandwidth (a copy does no float operation).  Also the bound that
    counts every slot's read."""
    k = int(idx.numel())
    distinct = int(idx.unique().numel())
    need = 4 * distinct * d + 4 * k * d + 8 * k
    every = 4 * k * d + 4 * k * d + 8 * k
    return (1e3 * need / HBM_BYTES_PER_S, 1e3 * every / HBM_BYTES_PER_S,
            distinct, need)


def gather_vs_plain(torch, ops, plain, tbl, idx, label, cold=False):
    """Hold the gather kernel against its plain version (bitwise) and time
    kernel, plain version and `torch.index_select` (`timings`)."""
    m, d = tbl.shape
    out = ops.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    ref = plain(tbl, idx)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    del out, ref
    t = timings(torch, lambda: ops.gather_rows(tbl, idx),
                lambda: plain(tbl, idx),
                lambda: torch.index_select(tbl, 0, idx), cold=cold)
    bound_ms, every_ms, distinct, need = gather_bound_ms(m, idx, d)
    print(f"gather_rows {label} [M={m}, K={idx.numel()}, D={d}, "
          f"{distinct} distinct rows]: torch.equal(kernel, plain)={equal} "
          f"max_abs_err={err:g} {timing_text(t, 'index_select', bound_ms)}; "
          f"bound {bound_ms:.4f} ms (bytes, {need / 1e6:.1f} MB), every-slot "
          f"bound {every_ms:.4f} ms (kernel device time at "
          f"{100 * every_ms / t['kernel_ms']:.1f}%)")
    check(equal, f"gather_rows {label}: kernel != plain (max_abs_err {err:g})")
    return dict(t, bound_ms=bound_ms, bound_by="bytes", max_abs_err=err,
                every_slot_bound_ms=every_ms, shape=[m, int(idx.numel()), d])


def small_world_agrees(torch, dev, comm=None, label="no transport",
                       method="decdiff+vt", layout=None, cnn=False):
    """The same small run on the card and on the CPU (same world, same
    init, no random draws in the rounds) must agree; with a transport the
    bytes on the wire must be equal.  The world: 16 nodes of synth-mnist
    with the MLP 784-64-32-10, or (`cnn`) 6 nodes of synth-fashion with the
    full-width Table I CNN."""
    from repro_torch.engine import Experiment, World
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.utils.pytree import tree_leaves

    runs = []
    for where in (dev, torch.device("cpu")):
        if cnn:
            world = World.synthetic("synth-fashion", nodes=6,
                                    topology="erdos_renyi", p=0.5,
                                    scale=0.004, device=where)
        else:
            world = World.synthetic("synth-mnist", nodes=16,
                                    topology="barabasi_albert", m=2,
                                    scale=0.03,
                                    model=make_mlp(hidden=(64, 32)),
                                    device=where)
        exp = Experiment(world, method, steps_per_round=2,
                         batch_size=32, device=where, comm=comm,
                         layout=layout)
        hist = exp.run(rounds=3, eval_every=1)
        runs.append((hist, [p.cpu() for p in tree_leaves(exp.params)],
                     len(world.x_test), list(exp.trig_history)))
    (hc, pc, n_test, tc), (hh, ph, _, th) = runs
    used = (n_test // min(128, n_test)) * min(128, n_test)
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    aerr = max(float(abs(a.acc_per_node - b.acc_per_node).max()) * used
               for a, b in zip(hc, hh))
    bytes_c = [m.bytes_on_wire for m in hc]
    bytes_h = [m.bytes_on_wire for m in hh]
    what = ("6 nodes, Table I CNN" if cnn else
            "16 nodes, MLP 784-64-32-10")
    print(f"small world ({what}, 3 rounds, {method}, "
          f"{label}, {exp.layout} layout) "
          f"card vs cpu: max |param diff| {perr:.3g}, max accuracy diff "
          f"{aerr:.3g} test samples, bytes on the wire card {bytes_c} cpu "
          f"{bytes_h}, triggered card {tc} cpu {th}")
    check(perr <= 1e-4, f"card and cpu params differ by {perr} ({label})")
    check(aerr <= 1.0 + 1e-6, f"card and cpu accuracy differ by {aerr} "
                              f"samples ({label})")
    check(bytes_c == bytes_h and tc == th,
          f"card and cpu bytes on the wire differ ({label}): {bytes_c} vs "
          f"{bytes_h}, triggered {tc} vs {th}")


def check_history(torch, exp, history, losses, label):
    from repro_torch.utils.pytree import tree_leaves

    check([m.round for m in history] == list(range(ROUNDS)),
          f"{label}: eval rounds {[m.round for m in history]}")
    for m in history:
        check(m.acc_per_node.shape == (exp.n,), f"{label}: acc shape")
        check(((m.acc_per_node >= 0) & (m.acc_per_node <= 1)).all(),
              f"{label}: accuracy outside [0, 1]")
        check(all(math.isfinite(x) for x in m.loss_per_node),
              f"{label}: eval loss")
    check(len(losses) == ROUNDS and all(math.isfinite(x) for x in losses),
          f"{label}: train losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(exp.params)),
          f"{label}: non-finite params")


def drive(torch, ops, exp, label):
    """One warm round, then ROUNDS fused rounds with every launch count set
    to 0 just before and read just after.  Returns the history, the
    launches, the ms per round and the transport's byte and trigger
    deltas over the measured rounds."""
    exp.run(rounds=1, eval_every=1)  # warm round
    torch.cuda.synchronize()
    bytes0 = exp.comm_bytes_total
    ntrig = len(exp.trig_history)
    ops.reset_launches()
    t0 = time.perf_counter()
    history = exp.run(rounds=ROUNDS, eval_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = exp.train_loss_history[-ROUNDS:]
    ms_round = 1e3 * wall / ROUNDS
    print(f"{label}: {ROUNDS} rounds (fused, eval every round) in "
          f"{wall:.3f} s = {ms_round:.2f} ms per round; kernel launches "
          f"{launches}")
    for m, loss in zip(history, losses):
        extra = ("" if m.bytes_on_wire is None else
                 f", bytes on the wire {m.bytes_on_wire:.0f}, triggered "
                 f"{m.triggered_frac:.4f}")
        print(f"  round {m.round}: mean acc {m.acc_mean:.4f}, "
              f"train loss {loss:.5f}{extra}")
    check_history(torch, exp, history, losses, label)
    return (history, launches, ms_round, exp.comm_bytes_total - bytes0,
            exp.trig_history[ntrig:])


def snapshot(torch, exp, history):
    """What the dense-against-sparse check compares, taken right after a
    path's measured rounds: params, accuracies, bytes, trigger history."""
    from repro_torch.utils.pytree import tree_leaves

    return dict(params=[p.clone() for p in tree_leaves(exp.params)],
                acc=[m.acc_per_node.copy() for m in history],
                bytes=exp.comm_bytes_total, trig=list(exp.trig_history),
                losses=list(exp.train_loss_history))


def sparse_equals_dense(torch, ops, world, dense, label, method, comm, sched,
                        launch_checks):
    """Run `label`'s experiment again with layout="sparse" (same seed, same
    call pattern as `drive`) and require params, accuracies, bytes and the
    trigger history bitwise equal to the dense run's snapshot."""
    from repro_torch.engine import Experiment
    from repro_torch.utils.pytree import tree_leaves

    exp = Experiment(world, method, schedule=sched, comm=comm,
                     layout="sparse")
    hist, launches, ms, _, _ = drive(torch, ops, exp,
                                     f"{label}, sparse layout")
    widths = exp.sparse_plan.widths
    same = (all(torch.equal(a, b) for a, b in
                zip(tree_leaves(exp.params), dense["params"]))
            and all((m.acc_per_node == a).all()
                    for m, a in zip(hist, dense["acc"]))
            and exp.comm_bytes_total == dense["bytes"]
            and exp.trig_history == dense["trig"]
            and exp.train_loss_history == dense["losses"])
    print(f"{label}: sparse layout (widths {list(widths)}) against dense: "
          f"params, accuracies, train losses, bytes and trigger history "
          f"bitwise equal = {same}; bytes {exp.comm_bytes_total:.0f} / "
          f"{dense['bytes']:.0f}")
    check(same, f"{label}: the sparse layout differs from the dense one")
    check(launches["segment_neighbor_avg"] == ROUNDS * len(widths)
          and launches["gather_rows"] == 0,
          f"{label}, sparse: launches {launches} (widths {widths})")
    for name, want in launch_checks.items():
        check(launches[name] == want,
              f"{label}, sparse: {name} launched {launches[name]} times, "
              f"not {want}")
    del exp
    gc.collect()
    return launches, ms


def dqseg_vs_plain(torch, ops, q, scales, w, label, time_it=True,
                   cold=False):
    """Hold `dequant_segment_neighbor_avg` against its plain version
    (bitwise) and against the fp32 route, the segment reduce over the
    decoded rows (within 1e-6 + 1e-5·Σ|w·s·q|: (w·s)·q associates
    differently from w·(s·q)); time the kernel, the plain version and
    `torch.einsum("bk,bkd->bd", ws, q.float())`.  Bound: q, scales and w
    read once, the [B, D] sums written once."""
    from repro_torch.kernels import segment_avg as sa

    b, k, d = q.shape
    out = ops.dequant_segment_neighbor_avg(q, scales, w)
    torch.cuda.synchronize()
    ws = (w * scales).contiguous()
    ref = sa.dequant_segment_avg_plain(q, ws)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    del ref
    route, _ = ops.segment_neighbor_avg(
        (q.float() * scales[:, :, None]).contiguous(), w)
    terms = torch.einsum("bk,bkd->bd", ws.abs(), q.float().abs())
    route_err = float((out - route).abs().max())
    route_ok = bool(((out - route).abs() <= 1e-6 + 1e-5 * terms).all())
    del route, terms, out
    res = dict(max_abs_err=err, fp32_route_err=route_err, shape=[b, k, d])
    if time_it:
        res.update(timings(
            torch, lambda: sa.dequant_segment_avg_cuda(q, ws),
            lambda: sa.dequant_segment_avg_plain(q, ws),
            lambda: torch.einsum("bk,bkd->bd", ws, q.float()), cold=cold))
        nbytes = b * k * d + 4 * (2 * b * k + b * d)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * b * k * d / FP32_FLOPS
        res.update(bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        timing = (f" {timing_text(res, 'einsum', res['bound_ms'])}; bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
                  f"{nbytes / 1e6:.1f} MB)")
    else:
        timing = ""
    print(f"dequant_segment_neighbor_avg {label} [B={b}, K={k}, D={d}]: "
          f"torch.equal(kernel, plain)={equal} max_abs_err={err:g}; "
          f"|kernel - fp32 route| {route_err:.3g} within 1e-6 + "
          f"1e-5·Σ|w·s·q| = {route_ok};{timing}")
    check(equal, f"dequant_segment_neighbor_avg {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    check(route_ok, f"dequant_segment_neighbor_avg {label}: the fp32 route "
                    f"differs by {route_err:g}")
    return res


def dqavg_vs_plain(torch, ops, q, scale, weights, label):
    """Hold `dequant_neighbor_avg` against its plain version and against
    row 0 of `dequant_neighbor_avg_rows` given the same normalized row
    (both bitwise), and against the oracle `dequant_neighbor_avg_ref`
    (rtol 1e-5, atol 1e-6); time the kernel, the plain version and
    `torch.mv(q.float().t(), ws)`.  Bound: q, the scales and the weights
    read once, the [D] average written once."""
    from repro_torch.kernels import dequant_avg as dq
    from repro_torch.kernels.ref import dequant_neighbor_avg_ref

    n, d = q.shape
    out = ops.dequant_neighbor_avg(q, scale, weights)
    torch.cuda.synchronize()
    wn = weights / torch.sum(weights)
    ws = (wn * scale).contiguous()
    ref = dq.dequant_avg_plain(q, ws)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    del ref
    row = dq.dequant_avg_rows_cuda(q, ws[None, :].contiguous())[0]
    row_equal = bool(torch.equal(out, row))
    del row
    oracle = dequant_neighbor_avg_ref(q, scale, weights)
    oracle_err = float((out - oracle).abs().max())
    oracle_ok = bool(((out - oracle).abs()
                      <= 1e-6 + 1e-5 * oracle.abs()).all())
    del oracle, out
    t = timings(torch, lambda: dq.dequant_avg_cuda(q, ws),
                lambda: dq.dequant_avg_plain(q, ws),
                lambda: torch.mv(q.float().t(), ws))
    nbytes = n * d + 4 * (2 * n + d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * n * d / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"dequant_neighbor_avg {label} [N={n}, D={d}]: torch.equal(kernel, "
          f"plain)={equal} max_abs_err={err:g}; bitwise row 0 of "
          f"dequant_neighbor_avg_rows = {row_equal}; |kernel - "
          f"dequant_neighbor_avg_ref| {oracle_err:.3g} (rtol 1e-5, atol "
          f"1e-6: {oracle_ok}); "
          f"{timing_text(t, 'torch.mv(q.float().t(), ws)', bound_ms)}; "
          f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB)")
    check(equal, f"dequant_neighbor_avg {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    check(row_equal, f"dequant_neighbor_avg {label}: not row 0 of "
                     f"dequant_neighbor_avg_rows")
    check(oracle_ok, f"dequant_neighbor_avg {label}: the oracle differs by "
                     f"{oracle_err:g}")
    return dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[n, d])


def profile_round(torch, run, label):
    """One call of `run` (one round) under torch.profiler: device time by
    kernel name and the device's busy share of the wall time.  Returns
    ({kernel name: (count, device us)}, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    # the first trace of a process also pays the profiler's start-up: trace
    # twice and keep the second
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the round's record_function ranges appear on the device timeline as
    # spans, not kernels: kept apart
    ranges = [e for e in on_dev if e.name.startswith("dfl_round.")]
    dev = [e for e in on_dev if not e.name.startswith("dfl_round.")]
    check(dev, "the profiler saw no device activity")
    by_name = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(t for _, t in by_name.values())
    print(f"profile of one {label} round: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of "
          f"wall), {len(dev)} device events over {len(by_name)} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :15]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / total:5.1f}%  x{n:<5d} "
              f"{name[:110]}")
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        inside = sum(e.time_range.elapsed_us() for e in dev
                     if lo <= e.time_range.start < hi)
        host = sum(e.cpu_time_total for e in prof.events()
                   if e.name == r.name
                   and e.device_type == torch.autograd.DeviceType.CPU)
        print(f"  range {r.name}: host {host / 1e3:.3f} ms, device span "
              f"{(hi - lo) / 1e3:.3f} ms, kernels in it {inside / 1e3:.3f} ms")
    return by_name, prof


# kernel-name families of path d's profile, matched in this order
LM_FAMILIES = (
    ("vt_kl_loss kernels", ("vt_fwd_kernel", "vt_bwd_kernel")),
    ("dequant_avg_rows kernel", ("dequant_avg_rows_kernel",)),
    ("decode_attention kernels", ("decode_tma_kernel",
                                  "decode_combine_kernel")),
    ("decdiff_update kernels", ("sumsq_rows_kernel", "scale_rows_kernel",
                                "step_rows_kernel")),
    ("GEMM (cuBLAS/CUTLASS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_",
                               "cublas", "nvjet")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat",
                                "index")),
)


def print_families(by_name, label):
    sums = {}
    for name, (_, t) in by_name.items():
        low = name.lower()
        fam = next((f for f, keys in LM_FAMILIES
                    if any(k.lower() in low for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + t
    total = sum(sums.values())
    print(f"{label} device time by family: " + ", ".join(
        f"{f} {t / 1e3:.3f} ms ({100 * t / total:.1f}%)"
        for f, t in sorted(sums.items(), key=lambda kv: -kv[1])))


def path_d(torch, ops, dev, profile):
    """The LM DFL pod round at full qwen1.5-0.5b width (see the module
    docstring).  Returns what the kernel phases need: the launches, the
    round times, the peak memory, and the kernels' real inputs (the final
    int8 payload with its weights, and node 0's logits and labels)."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import _normalized, build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import (
        tree_flatten_stacked,
        tree_leaves,
        tree_map,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_lm(get_config(LM_ARCH))
    params = init_nodes(lm, LM_NODES, dev)
    d = sum(t[0].numel() for t in tree_leaves(params))
    check(d == LM_PARAMS, f"{LM_ARCH} has {d} params per node")
    check(all(t.dtype == torch.bfloat16 for t in tree_leaves(params)),
          "full-width params are not bf16")
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    codec = Int8Codec(stochastic=False)
    adj = ring_adjacency(LM_NODES)
    rnd = build_dfl_round_shardmap(lm, opt, adj, loss_kind="vt",
                                   beta=LM_BETA, codec=codec)
    batches = list(make_batches(lm, LM_NODES, LM_BATCH, LM_SEQ, 1 + ROUNDS,
                                dev))
    torch.cuda.synchronize()
    print(f"path d set-up in {time.perf_counter() - t0:.1f} s: {LM_ARCH} "
          f"full width, {LM_NODES} nodes x {d} bf16 params, "
          f"{len(tree_leaves(params))} leaves per node, batch {LM_BATCH} x "
          f"seq {LM_SEQ} per node")
    t0 = time.perf_counter()
    params, state, loss = rnd(params, state, 0, batches[0])  # warm round
    warm = float(loss)
    torch.cuda.synchronize()
    print(f"path d warm round: {1e3 * (time.perf_counter() - t0):.1f} ms, "
          f"loss {warm:.5f}")
    ops.reset_launches()
    alloc0 = torch.cuda.memory_stats()
    ms, losses = [], []
    for r in range(1, ROUNDS + 1):
        t0 = time.perf_counter()
        params, state, loss = rnd(params, state, r, batches[r])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        if r == M2_ROUNDS:  # path m2's point of comparison, outside the clock
            digests = lm_node_digests(torch, params)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    alloc1 = torch.cuda.memory_stats()
    print("path d caching allocator over the measured rounds: " + ", ".join(
        f"{k} +{alloc1.get(k, 0) - alloc0.get(k, 0)}"
        for k in ("num_device_alloc", "num_device_free", "num_alloc_retries",
                  "num_sync_all_streams")))
    print(f"path d (LM DFL pod round, fused int8): {ROUNDS} rounds, ms per "
          f"round {', '.join(f'{x:.2f}' for x in ms)} (median "
          f"{statistics.median(ms):.2f}); losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}")
    check(all(math.isfinite(x) for x in [warm] + losses),
          f"path d losses {losses}")
    check(launches["dequant_neighbor_avg_rows"] == ROUNDS,
          f"dequant_neighbor_avg_rows launched "
          f"{launches['dequant_neighbor_avg_rows']} times in {ROUNDS} rounds")
    check(launches["decdiff_update"] == ROUNDS,
          f"decdiff_update launched {launches['decdiff_update']} times in "
          f"{ROUNDS} rounds")
    check(launches["vt_kl_loss_fwd"] == launches["vt_kl_loss_bwd"]
          == LM_NODES * ROUNDS,
          f"vt_kl_loss launches {launches} in {LM_NODES * ROUNDS} "
          f"node-steps")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          "path d: non-finite params")
    if profile:
        box = [params, state]

        def one_round():
            box[0], box[1], _ = rnd(box[0], box[1], ROUNDS, batches[-1])

        by_name, prof = profile_round(torch, one_round, "path d (LM pod)")
        print_families(by_name, "path d")
        averages = prof.key_averages()
        print("  host time by op (self, top 12; the backward runs on "
              "autograd's device thread while the range's own thread "
              "waits):")
        for e in sorted(averages, key=lambda e: -e.self_cpu_time_total)[:12]:
            print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
                  f"{e.key[:100]}")
        params, state = box
    # the kernels' real inputs at this path's shapes
    node0 = tree_map(lambda t: t[0], params)
    with torch.no_grad():
        logits, _ = lm.forward(node0, {k: v[0] for k, v in
                                       batches[-1].items()})
    w, _ = tree_flatten_stacked(params)
    payload, _ = codec.encode(w)
    wn, row = _normalized(torch.from_numpy(adj).to(dev), None)
    return dict(launches=launches, ms=ms, losses=losses, peak=peak,
                digests=digests, q=payload["q"], scale=payload["scale"],
                wn=wn.contiguous(), w=w, row=row.contiguous(),
                logits=logits.reshape(-1, logits.shape[-1]).contiguous(),
                labels=batches[-1]["labels"][0].reshape(-1).contiguous())


def ge_walk_rows(exp):
    """CFA-GE's gradient walk on `exp`: its row-gradients and calls per
    round, beside what the reference's walks evaluate (the dense slot walk
    N·max_deg rows, the sparse bucket walk Σ B·width), as one line."""
    from repro_torch.engine import backends
    from repro_torch.engine.neighborhood import _bucket_width

    e = int(exp._total_directed)
    chunk = min(e, backends.GE_CHUNK)
    calls = -(-e // chunk)
    degrees = (exp.sparse_plan.degrees if exp.layout == "sparse"
               else exp.nbr_valid.sum(dim=1))
    buckets = sum(_bucket_width(int(d)) for d in degrees.tolist())
    return (f"gradient walk {e} row-gradients per round in {calls} calls "
            f"of at most {chunk} (E = {e}; the reference's sparse "
            f"bucket walk {buckets}, its dense slot walk "
            f"{exp.n * int(exp.topo.max_degree)})")


def path_h(torch, ops, dev, profile):
    """The sparse layout at the paper MLP's full width (see the module
    docstring).  Returns each run's launches, ms per round and peak memory,
    the int8 route's launches, and the B.5 checks on the round's real
    int8 payloads."""
    from repro_torch.comm import CommConfig
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.utils.pytree import tree_flatten_stacked

    t0 = time.perf_counter()
    world = World.synthetic("synth-mnist", nodes=H_NODES,
                            topology="barabasi_albert", m=2, scale=1.0)
    sched = Schedule(rounds=ROUNDS, eval_every=1)
    print(f"path h world built in {time.perf_counter() - t0:.1f} s: "
          f"{H_NODES} nodes, max degree {world.topo.max_degree}, "
          f"{int(world.topo.neighbor_mask.sum())} directed edges")
    out = {}
    payload = plan = None
    for key, label, comm in [
            ("h0", "no transport", None),
            ("h1", "per-edge int8 adaptive 0.95",
             CommConfig(codec="int8", policy="adaptive",
                        target_trigger=0.95)),
            ("h2", "per-node int8, always send", CommConfig(codec="int8"))]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        exp = Experiment(world, "decdiff+vt", schedule=sched, comm=comm,
                         layout="sparse")
        n_params = tree_flatten_stacked(exp.params)[0].shape[1]
        n_dir, widths = exp.sparse_plan.num_directed, exp.sparse_plan.widths
        check(n_params == 567434 and exp.layout == "sparse",
              f"path h: {n_params} params, layout {exp.layout}")
        hist, launches, ms, bytes_d, trig = drive(
            torch, ops, exp, f"path h ({H_NODES} nodes, sparse, {label})")
        peak = torch.cuda.max_memory_allocated()
        print(f"path h ({label}): {ms:.2f} ms per round, peak device memory "
              f"{peak / 2**30:.2f} GiB ({peak} B), bucket widths "
              f"{list(widths)}, {n_dir} directed edges")
        check(launches["segment_neighbor_avg"] == ROUNDS * len(widths)
              and launches["gather_rows"] == 0
              and launches["decdiff_update"] == ROUNDS
              and launches["drift_norms"] == (0 if comm is None else ROUNDS)
              and launches["vt_kl_loss_fwd"] == launches["vt_kl_loss_bwd"]
              == ROUNDS * exp.train.steps_per_round,
              f"path h ({label}): launches {launches}")
        fired = None
        if comm is not None:
            payload_b = exp.transport.payload_bytes
            check(payload_b == n_params + 4, f"int8 payload {payload_b} B")
            sent = [t * n_dir for t in trig]
            check(all(abs(x - round(x)) < 1e-3 for x in sent),
                  f"path h: fired edges per round {sent}")
            fired = sum(round(x) for x in sent)
            print(f"path h ({label}): fired edges per round "
                  f"{[round(x) for x in sent]}, bytes on the wire "
                  f"{bytes_d:.0f} = {payload_b} x {fired}")
            check(bytes_d == payload_b * fired
                  and fired <= n_dir * ROUNDS and fired > 0,
                  f"path h bytes {bytes_d} != {payload_b} x {fired}")
            if key == "h2":
                check(trig == [1.0] * ROUNDS, f"path h per-node trig {trig}")
        if profile and key in ("h0", "h1"):
            profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                          f"path h {label} (eval included)")
        out[key] = dict(launches=launches, ms=ms, peak=peak, bytes=bytes_d,
                        fired=fired)
        if key == "h0":
            # the round's int8 payloads, as a user's codec encodes them
            payload, _ = Int8Codec(stochastic=False).encode(
                tree_flatten_stacked(exp.params)[0])
            plan = exp.sparse_plan
        del exp, hist

    # CFA-GE on the same world and layout: Eq. 9 over the buckets, then
    # the gradient walk over the directed edges
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exp = Experiment(world, "cfa-ge", schedule=sched, layout="sparse")
    hist, launches, ms, _, _ = drive(
        torch, ops, exp, f"path h ({H_NODES} nodes, sparse, cfa-ge)")
    peak = torch.cuda.max_memory_allocated()
    walk = ge_walk_rows(exp)
    print(f"path h (cfa-ge): {ms:.2f} ms per round, peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); {walk}")
    check(launches["segment_neighbor_avg"] == ROUNDS * len(widths)
          and launches["gather_rows"] == 0 and launches["neighbor_avg"] == 0
          and launches["decdiff_update"] == 0,
          f"path h (cfa-ge): launches {launches}")
    if profile:
        profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                      "path h cfa-ge (eval included)")
    out["h3"] = dict(launches=launches, ms=ms, peak=peak, bytes=0.0,
                     fired=None, walk=walk)
    del exp, hist
    # path l3: telemetry on this world
    out["l3"] = path_l3(torch, ops, world)
    del world
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 route of one sparse round through the reference's entry
    # point, `dequant_segment_neighbor_avg`, one call per width bucket
    q, scale = payload["q"], payload["scale"]
    panels = [(wd, plan.buckets[wd].src[0], plan.buckets[wd].wgt[0])
              for wd in plan.widths]
    ops.reset_launches()
    t0 = time.perf_counter()
    for _, src, wgt in panels:
        sums = ops.dequant_segment_neighbor_avg(q[src], scale[src], wgt)
        del sums
    torch.cuda.synchronize()
    route_ms = 1e3 * (time.perf_counter() - t0)
    out["hq"] = dict(launches=dict(ops.LAUNCHES), ms=route_ms)
    print(f"path h int8 route (dequant_segment_neighbor_avg over the "
          f"{len(panels)} buckets of the round's [{H_NODES}, "
          f"{q.shape[1]}] int8 payload): {route_ms:.2f} ms, kernel launches "
          f"{out['hq']['launches']}")
    check(out["hq"]["launches"]["dequant_segment_neighbor_avg"]
          == len(panels), f"path h int8 route launches {out['hq']}")
    biggest = max(panels, key=lambda p: p[1].numel())[0]
    out["bucket_checks"] = []
    for wd, src, wgt in panels:
        out["bucket_checks"].append(dqseg_vs_plain(
            torch, ops, q[src], scale[src].contiguous(), wgt,
            f"path h width-{wd} bucket (real int8 payloads)",
            time_it=wd == biggest))
    del q, scale, payload, panels
    return out


def path_i(torch, ops, dev, profile):
    """Node scale: `benchmarks/bench_scale.py:tiny_world` at 10,000 nodes
    on the sparse layout, its engine tier (see the module docstring).
    Returns each run's launches, rounds per second and bytes."""
    import numpy as np

    import dataclasses

    from repro_torch.comm import CommConfig
    from repro_torch.dynamics import EdgeDropout
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.graphs.sparse import sparse_barabasi_albert
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.utils.pytree import tree_flatten_stacked

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    dim, per_node, classes = 16, 4, 10
    xs = [rng.normal(size=(per_node, dim)).astype(np.float32)
          for _ in range(I_NODES)]
    ys = [rng.integers(0, classes, size=per_node).astype(np.int32)
          for _ in range(I_NODES)]
    x_test = rng.normal(size=(64, dim)).astype(np.float32)
    y_test = rng.integers(0, classes, size=64).astype(np.int32)
    st = sparse_barabasi_albert(n=I_NODES, m=2, seed=0)
    check(st.num_directed == 39964 and st.max_degree == 204,
          f"path i graph: {st.num_directed} directed edges, max degree "
          f"{st.max_degree}")
    world = World(model=make_mlp(num_classes=classes, input_dim=dim,
                                 hidden=(32,)),
                  topo=st, xs=xs, ys=ys, x_test=x_test, y_test=y_test)
    try:
        Experiment(world, "decdiff", layout="dense")
        refused = False
    except ValueError as e:
        refused = "refusing to densify" in str(e)
    check(refused, "path i: the dense layout was not refused at 10^4 nodes")
    print(f"path i world built in {time.perf_counter() - t0:.1f} s: "
          f"{I_NODES} nodes, {st.num_directed} directed edges, max degree "
          f"{st.max_degree}; the dense layout is refused at this size")
    out = {}
    edge06 = CommConfig(codec="int8", policy="adaptive", target_trigger=0.6,
                        per_edge=True)
    for key, method, label, comm, dyn in [
            ("i0", "decdiff", "no transport", None, None),
            ("i1", "decdiff", "per-edge int8 adaptive 0.6", edge06, None),
            ("i2", "cfa-ge", "no transport", None, None),
            # bench_scale.py's dynamics tier
            ("i3", "decdiff", "per-edge int8 adaptive 0.6, "
             "EdgeDropout(p=0.2)", edge06, EdgeDropout(p=0.2))]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        exp = Experiment(dataclasses.replace(world, dynamics=dyn), method,
                         comm=comm,
                         schedule=Schedule(rounds=ROUNDS, eval_every=ROUNDS,
                                           mode="loop"),
                         steps_per_round=1, batch_size=4, eval_batch=64,
                         lr=0.1, seed=0)
        setup = time.perf_counter() - t0
        n_params = tree_flatten_stacked(exp.params)[0].shape[1]
        widths = exp.sparse_plan.widths
        check(exp.layout == "sparse" and n_params == 874,
              f"path i: layout {exp.layout}, {n_params} params")
        exp.run()  # warm run
        torch.cuda.synchronize()
        bytes0, ntrig = exp.comm_bytes_total, len(exp.trig_history)
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = exp.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        rps = ROUNDS / wall
        trig = exp.trig_history[ntrig:]
        bytes_d = exp.comm_bytes_total - bytes0
        print(f"path i ({I_NODES} nodes, sparse, {method}, {label}): "
              f"set-up {setup:.1f} s; {ROUNDS} rounds (loop) in {wall:.3f} s "
              f"= {rps:.2f} rounds per second; mean acc "
              f"{hist[-1].acc_mean:.4f}; triggered {trig}; bytes on the "
              f"wire {bytes_d:.0f}; peak device memory "
              f"{peak / 2**30:.3f} GiB ({peak} B); widths {list(widths)}; "
              f"kernel launches {launches}")
        check(hist[-1].acc_per_node.shape == (I_NODES,)
              and bool(np.isfinite(hist[-1].loss_per_node).all()),
              f"path i ({label}): eval")
        check(launches["segment_neighbor_avg"] == ROUNDS * len(widths)
              and launches["gather_rows"] == 0
              and launches["decdiff_update"] == (
                  ROUNDS if method == "decdiff" else 0)
              and launches["drift_norms"] == (0 if comm is None else ROUNDS)
              and launches["vt_kl_loss_fwd"] == 0,
              f"path i ({method}, {label}): launches {launches}")
        walk = None
        if method == "cfa-ge":
            walk = ge_walk_rows(exp)
            print(f"path i (cfa-ge): {walk}")
        live = None
        if comm is not None:
            # under dynamics trig is fired over the round's live edges
            lives = ([st.num_directed] * ROUNDS if dyn is None else
                     [f * st.num_directed for f in exp.live_history[-ROUNDS:]])
            sent = [t * lv for t, lv in zip(trig, lives)]
            fired = sum(round(x) for x in sent)
            check(all(abs(x - round(x)) < 1e-2 for x in sent + lives)
                  and bytes_d == exp.transport.payload_bytes * fired
                  and 0 < fired <= sum(round(x) for x in lives),
                  f"path i bytes {bytes_d}, fired {sent}, live {lives}")
        if dyn is not None:
            live = exp.live_history[-ROUNDS:]
            print(f"path i ({label}): live fraction per round {live}, "
                  f"live_edge_frac {hist[-1].live_edge_frac}, triggered "
                  f"fraction of the live edges {trig}")
            check(all(0.0 < f < 1.0 for f in live),
                  f"path i3: live fractions {live}")
        out[key] = dict(launches=launches, rps=rps, wall=wall, trig=trig,
                        bytes=bytes_d, peak=peak, walk=walk, live=live)
        if profile:
            profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                          f"path i {method} {label} (eval included)")
        del exp, hist

    def make_l4(w):
        """i1's experiment over `w` (path l4)."""
        return Experiment(w, "decdiff", comm=edge06,
                          schedule=Schedule(rounds=ROUNDS, eval_every=ROUNDS,
                                            mode="loop"),
                          steps_per_round=1, batch_size=4, eval_batch=64,
                          lr=0.1, seed=0)

    gc.collect()
    out["l4"] = path_l4(torch, ops, world, make_l4)
    del world
    gc.collect()
    return out


# ----------------------------------------------------------------- path k

# path k's clock: bench_time.py's node model, and its links at 10x the
# bandwidth (at 1e5 B/s the full-width payload would miss every deadline)
K_LINK = dict(latency_median=0.05, latency_sigma=0.5, bandwidth_median=1e6,
              bandwidth_sigma=0.5, seed=11)
K_NODE = dict(median=1.0, sigma=0.5, seed=7)
K_DEADLINE = 6.0


def k_expected_launches(ops, exp, method):
    """A path-k run's launches over ROUNDS rounds: path j's roster counts,
    with the segment reduce once per width bucket and round on the sparse
    layout and `gather_rows` once a round on the dense per-edge transport.
    A dead node still runs its masked local steps, so the VT kernels launch
    once a local step whatever the churn.  A transport's drift norms
    launch once a round."""
    want = j_expected_launches(ops, method, exp.train.steps_per_round)
    if exp.layout == "sparse" and want["segment_neighbor_avg"]:
        want["segment_neighbor_avg"] = ROUNDS * len(exp.sparse_plan.widths)
    if exp.layout == "dense" and exp.comm is not None \
            and exp.comm.use_per_edge:
        want["gather_rows"] = ROUNDS
    if exp.comm is not None:
        want["drift_norms"] = ROUNDS
    return want


def record_alive(exp):
    """Record each round's [N] aliveness and rejoin flags as the engine
    realizes them, and each round's params before and after (the round
    function wrapped)."""
    bound, events, rounds = exp.bound_dyn, [], []
    inner_t, inner_r = bound.transition, exp._round

    def transition(*args):
        state, ev = inner_t(*args)
        events.append((ev.alive.clone(), ev.rejoined.clone()))
        return state, ev

    def copy(p):
        return {k: {kk: t.clone() for kk, t in v.items()}
                for k, v in p.items()}

    def round_fn(params, *rest):
        # both copies: the next round's local steps update params in place
        before = copy(params)
        out = inner_r(params, *rest)
        rounds.append((before, copy(out[0])))
        return out

    object.__setattr__(bound, "transition", transition)
    exp._round = round_fn
    return events, rounds


def drive_k(torch, ops, exp, label, method="decdiff+vt"):
    """`drive` (one warm round, then ROUNDS fused rounds, the counts set to
    0 just before and read just after) with the peak device memory (and
    its rise over what was allocated before the run: the earlier paths'
    experiments are still alive), the live-edge and arrived fractions and
    the simulated seconds, and the launches checked exactly."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist, launches, ms, bytes_d, trig = drive(torch, ops, exp, label)
    peak = torch.cuda.max_memory_allocated()
    m = hist[-1]
    print(f"{label}: {ms:.2f} ms per round, peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B), {(peak - base) / 2**30:.2f} "
          f"GiB above the {base} B allocated before it; live_edge_frac "
          f"{m.live_edge_frac}, arrived_frac {m.arrived_frac}, sim_time "
          f"{m.sim_time}; per round live {exp.live_history[-ROUNDS:]}, "
          f"arrived {exp.arrived_history[-ROUNDS:]}, simulated seconds "
          f"{exp.sim_time_history[-ROUNDS:]}")
    want = k_expected_launches(ops, exp, method)
    check(launches == want, f"{label}: launches {launches}, not {want}")
    return dict(hist=hist, launches=launches, ms=ms, peak=peak,
                rise=peak - base, bytes=bytes_d, trig=trig,
                live=list(exp.live_history),
                arrived=list(exp.arrived_history),
                sim=list(exp.sim_time_history),
                live_frac=m.live_edge_frac, arrived_frac=m.arrived_frac,
                sim_time=m.sim_time)


def same_k(torch, a, b):
    """Two path-k runs bitwise equal: params, accuracies, train losses,
    bytes, trigger, live, arrived and simulated-seconds histories."""
    from repro_torch.utils.pytree import tree_leaves

    ea, eb = a["exp"], b["exp"]
    return (all(torch.equal(x, y) for x, y in zip(tree_leaves(ea.params),
                                                  tree_leaves(eb.params)))
            and all((x.acc_per_node == y.acc_per_node).all()
                    for x, y in zip(a["hist"], b["hist"]))
            and ea.train_loss_history == eb.train_loss_history
            and ea.comm_bytes_total == eb.comm_bytes_total
            and ea.trig_history == eb.trig_history
            and ea.live_history == eb.live_history
            and ea.arrived_history == eb.arrived_history
            and ea.sim_time_history == eb.sim_time_history)


def k_bytes_check(exp, run, n_dir, label):
    """Bytes on the wire = payload x fired live edges, exactly: per round
    fired = trig x live edges (trig is fired over live)."""
    payload = exp.transport.payload_bytes
    lives = [f * n_dir for f in run["live"][-ROUNDS:]]
    sent = [t * lv for t, lv in zip(run["trig"], lives)]
    check(all(abs(x - round(x)) < 1e-3 for x in sent + lives),
          f"{label}: fired {sent}, live {lives}")
    fired = sum(round(x) for x in sent)
    print(f"{label}: live edges per round {[round(x) for x in lives]}, "
          f"fired {[round(x) for x in sent]}, bytes on the wire "
          f"{run['bytes']:.0f} = {payload} x {fired}")
    check(run["bytes"] == payload * fired and 0 < fired
          and all(round(x) <= round(lv) for x, lv in zip(sent, lives)),
          f"{label}: bytes {run['bytes']} != {payload} x {fired}")


def small_dyn_agrees(torch, dev, label, dynamics, timing=None,
                     deadline=None, comm=None, method="decdiff+vt"):
    """A small world under a deterministic process, on the card and on
    the CPU: params to 1e-4, accuracy to one test sample, bytes, live and
    arrived fractions and simulated seconds exactly."""
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.utils.pytree import tree_leaves

    runs = []
    for where in (dev, torch.device("cpu")):
        world = World.synthetic("synth-mnist", nodes=16,
                                topology="barabasi_albert", m=2, scale=0.03,
                                model=make_mlp(hidden=(64, 32)),
                                device=where, dynamics=dynamics,
                                timing=timing)
        exp = Experiment(world, method, steps_per_round=2, batch_size=32,
                         device=where, comm=comm,
                         schedule=Schedule(rounds=3, eval_every=1,
                                           deadline=deadline))
        hist = exp.run()
        runs.append((hist, [p.cpu() for p in tree_leaves(exp.params)],
                     len(world.x_test), exp))
    (hc, pc, n_test, ec), (hh, ph, _, eh) = runs
    used = (n_test // min(128, n_test)) * min(128, n_test)
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    aerr = max(float(abs(a.acc_per_node - b.acc_per_node).max()) * used
               for a, b in zip(hc, hh))
    fields = ("bytes_on_wire", "triggered_frac", "live_edge_frac",
              "sim_time", "arrived_frac")
    same = all(getattr(a, f) == getattr(b, f) for a, b in zip(hc, hh)
               for f in fields) and ec.live_history == eh.live_history
    print(f"small world (16 nodes, MLP 784-64-32-10, 3 rounds, {method}, "
          f"{label}) card vs cpu: max |param diff| {perr:.3g}, max accuracy "
          f"diff {aerr:.3g} test samples; live {ec.live_history}, simulated "
          f"seconds {ec.sim_time_history}, arrived {ec.arrived_history}: "
          f"bytes / live / time / arrived equal = {same}")
    check(perr <= 1e-4 and aerr <= 1.0 + 1e-6 and same,
          f"small world card vs cpu differ ({label})")
    check(min(ec.live_history) < 1.0, f"small world ({label}): no edge "
                                      f"went down")


def path_k(torch, ops, dev, world, snap_a, profile):
    """Time-varying graphs and the event clock on a-c's world at full width
    (see the module docstring).  Returns each run's summary."""
    import dataclasses

    import numpy as np

    from repro_torch.comm import CommConfig
    from repro_torch.dynamics import (EdgeDropout, EnergyChurn,
                                      GilbertElliott, PeriodicRewiring,
                                      ScriptedGraph, StaticGraph)
    from repro_torch.engine import Experiment, Schedule
    from repro_torch.timing import LognormalLink, LognormalStep, Timing
    from repro_torch.utils.pytree import tree_leaves

    sched = Schedule(rounds=ROUNDS, eval_every=1)
    n_dir = int(world.topo.neighbor_mask.sum())
    edge_int8 = CommConfig(codec="int8", policy="adaptive",
                           target_trigger=0.95)
    clock = Timing(LognormalStep(**K_NODE), LognormalLink(**K_LINK))
    out = {}

    def run(key, label, method="decdiff+vt", dynamics=None, timing=None,
            **kw):
        w = dataclasses.replace(world, dynamics=dynamics, timing=timing)
        exp = Experiment(w, method, **kw)
        r = drive_k(torch, ops, exp, f"path {key} ({label})", method)
        r["exp"] = exp
        out[key] = r
        return r

    # -- k0: the identity process and the degenerate clock = path a ------
    k0 = run("k0", "StaticGraph(), Timing(), no transport",
             dynamics=StaticGraph(), timing=Timing(), schedule=sched)
    e0 = k0["exp"]
    same = (all(torch.equal(a, b) for a, b in
                zip(tree_leaves(e0.params), snap_a["params"]))
            and all((m.acc_per_node == a).all()
                    for m, a in zip(k0["hist"], snap_a["acc"]))
            and e0.train_loss_history == snap_a["losses"])
    print(f"path k0: params, accuracies and train losses bitwise equal to "
          f"path a = {same}")
    check(same, "path k0 differs from path a")
    steps = float(e0.train.steps_per_round)
    check(e0.live_history == [1.0] * (ROUNDS + 1)
          and e0.arrived_history == [1.0] * (ROUNDS + 1)
          and e0.sim_time_history == [steps * (r + 1)
                                      for r in range(ROUNDS + 1)],
          f"path k0: live {e0.live_history}, simulated seconds "
          f"{e0.sim_time_history}")
    del e0, k0["exp"]

    # -- k1: EdgeDropout(0.2) with the per-edge int8 transport, both layouts
    k1 = run("k1", "EdgeDropout(p=0.2), per-edge int8 adaptive 0.95, dense",
             dynamics=EdgeDropout(p=0.2), schedule=sched, comm=edge_int8)
    k1s = run("k1_s", "EdgeDropout(p=0.2), per-edge int8 adaptive 0.95, "
              "sparse", dynamics=EdgeDropout(p=0.2), schedule=sched,
              comm=edge_int8, layout="sparse")
    same = same_k(torch, k1, k1s)
    print(f"path k1: sparse layout against dense bitwise equal = {same}")
    check(same, "path k1: the sparse layout differs from the dense one")
    check(0.0 < k1["live_frac"] < 1.0 and min(k1["live"]) > 0.0,
          f"path k1: live fractions {k1['live']}")
    k_bytes_check(k1["exp"], k1, n_dir, "path k1")
    if profile:
        profile_round(torch, lambda: k1["exp"].run(rounds=1, eval_every=1),
                      "path k1 EdgeDropout per-edge int8 (eval included)")
    del k1["exp"], k1s["exp"]

    # -- k2: EnergyChurn under the clock, decdiff+vt per node and fedavg --
    churn = EnergyChurn(capacity=8.0, recharge=4.0, rejoin_at=4.0)
    for key, method, comm in [("k2", "decdiff+vt", CommConfig(codec="int8")),
                              ("k2_fedavg", "fedavg", None)]:
        w = dataclasses.replace(world, dynamics=churn, timing=clock)
        exp = Experiment(w, method, schedule=sched, comm=comm)
        exp.run(rounds=1, eval_every=1)  # the warm round of `drive`, here
        events, rounds = record_alive(exp)
        resets = []
        if comm is not None:
            inner_reset = exp.transport.reset_rows

            def reset_rows(state, reset, inner=inner_reset, **kw):
                resets.append(int((reset > 0).sum()))
                return inner(state, reset, **kw)

            exp.transport.reset_rows = reset_rows
        gc.collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = exp.run(rounds=ROUNDS, eval_every=1)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        label = (f"path {key} (EnergyChurn(8, 4, 4), LognormalStep + "
                 f"LognormalLink at 1e6 B/s, {method}"
                 + (", per-node int8)" if comm is not None else ")"))
        check_history(torch, exp, hist, exp.train_loss_history[-ROUNDS:],
                      label)
        alive = [al for al, _ in events]
        died = int(sum(int((al == 0).sum()) for al in alive))
        rejoined = int(sum(float(rj.sum()) for _, rj in events))
        frozen = all(
            torch.equal(after[k][kk][dead], before[k][kk][dead])
            for (before, after), al in zip(rounds, alive)
            for dead in [al == 0] for k in before for kk in before[k])
        m = hist[-1]
        print(f"{label}: {ROUNDS} rounds (fused, with the recording wrapper "
              f"that clones the params each round) in {ms:.2f} ms per round, "
              f"peak device memory {peak / 2**30:.2f} GiB ({peak} B), "
              f"{(peak - base) / 2**30:.2f} GiB above the {base} B allocated "
              f"before it; alive "
              f"per round {[int(x.sum()) for x in alive]} of {exp.n}, "
              f"node-rounds dead {died}, rejoins {rejoined}, reset_rows "
              f"calls {len(resets)} resetting {resets} rows; dead rows "
              f"bitwise frozen = {frozen}; live_edge_frac "
              f"{m.live_edge_frac}, arrived_frac {m.arrived_frac}, sim_time "
              f"{m.sim_time}; simulated seconds per round "
              f"{exp.sim_time_history[-ROUNDS:]}; kernel launches "
              f"{launches}")
        want = k_expected_launches(ops, exp, method)
        check(launches == want, f"{label}: launches {launches}, not {want}")
        check(died > 0 and rejoined > 0 and frozen,
              f"{label}: died {died}, rejoined {rejoined}, frozen {frozen}")
        if comm is not None:
            check(len(resets) == ROUNDS and sum(resets) == rejoined,
                  f"{label}: reset_rows {resets}, rejoins {rejoined}")
        out[key] = dict(hist=hist, launches=launches, ms=ms, peak=peak,
                        rise=peak - base, live_frac=m.live_edge_frac,
                        arrived_frac=m.arrived_frac, sim_time=m.sim_time,
                        died=died, rejoined=rejoined)
        if profile and comm is not None:
            profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                          "path k2 EnergyChurn decdiff+vt per-node int8 "
                          "(eval included)")
        del exp, hist, rounds

    # -- k3: deadline ticks, the per-edge transport and k2's clock --------
    runs = {}
    for layout in ("dense", "sparse"):
        for mode in ("fused", "loop"):
            if layout == "sparse" and mode == "loop":
                continue
            key = "k3" if (layout, mode) == ("dense", "fused") \
                else f"k3_{layout}_{mode}"
            runs[layout, mode] = run(
                key, f"Schedule(deadline={K_DEADLINE}), per-edge int8 "
                f"adaptive 0.95, LognormalStep + LognormalLink at 1e6 B/s, "
                f"{layout}, {mode}", timing=clock, layout=layout,
                comm=edge_int8,
                schedule=Schedule(rounds=ROUNDS, eval_every=1, mode=mode,
                                  deadline=K_DEADLINE))
    k3 = runs["dense", "fused"]
    ticks = [K_DEADLINE * (r + 1) for r in range(ROUNDS + 1)]
    same = (same_k(torch, k3, runs["dense", "loop"])
            and same_k(torch, k3, runs["sparse", "fused"]))
    print(f"path k3: fused = loop and sparse = dense bitwise = {same}; "
          f"simulated seconds {k3['sim']} (want {ticks}); arrived per round "
          f"{k3['arrived']}")
    check(same, "path k3: fused / loop / sparse runs differ")
    check(k3["sim"] == ticks, f"path k3: simulated seconds {k3['sim']}")
    check(all(0.0 < a < 1.0 for a in k3["arrived"]),
          f"path k3: arrived fractions {k3['arrived']}")
    for r in runs.values():
        del r["exp"]

    # -- k4: bursty links and the rewiring union layout, no transport -----
    for key, label, dyn in [
            ("k4_ge", "GilbertElliott(p_gb=0.1, p_bg=0.3)",
             GilbertElliott(p_gb=0.1, p_bg=0.3)),
            ("k4_rewire", "PeriodicRewiring(period=1, num_graphs=4)",
             PeriodicRewiring(period=1, num_graphs=4))]:
        r = run(key, label, dynamics=dyn, schedule=sched)
        e = r["exp"]
        print(f"path {key}: layout {e.topo.name}, max degree "
              f"{e.topo.max_degree}, {int(e.topo.neighbor_mask.sum())} "
              f"directed edges; stationary live fraction "
              f"{e.bound_dyn.stationary_live_frac}")
        check(0.0 < r["live_frac"] < 1.0 and min(r["live"]) > 0.0,
              f"path {key}: live fractions {r['live']}")
        del e, r["exp"]

    # -- card against CPU: the deterministic processes --------------------
    from repro_torch.graphs.topology import make_topology

    m16 = int(np.triu(make_topology("barabasi_albert", n=16, m=2,
                                    seed=0).adjacency, 1).sum())
    small_dyn_agrees(
        torch, dev, "ScriptedGraph, per-edge int8 adaptive 0.95",
        ScriptedGraph(np.random.default_rng(5).integers(
            0, 2, (3, m16)).astype(np.float32)),
        comm=CommConfig(codec="int8", policy="adaptive", target_trigger=0.95,
                        stochastic=False))
    small_dyn_agrees(
        torch, dev, "EnergyChurn(3, 4, 2), deadline 2.5",
        EnergyChurn(capacity=3.0, recharge=4.0, rejoin_at=2.0),
        timing=clock, deadline=2.5)
    gc.collect()
    return out


# ----------------------------------------------------------------- path l

L_ROUNDS = 5                          # measured rounds of l0-l2 per run
L_DIR = ROOT / "build" / "path_l"     # path l's ledgers, traces, profiles


def l_expected_launches(ops, exp, method, rounds):
    """A path-l run's launches over `rounds` rounds: path j's roster
    counts, with the segment reduce once per width bucket and round on the
    sparse layout, `gather_rows` once a round on the dense per-edge
    transport and the drift norms once a round on any transport."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if method.startswith("decdiff"):
        want["segment_neighbor_avg"] = rounds * (
            len(exp.sparse_plan.widths) if exp.layout == "sparse" else 1)
        want["decdiff_update"] = rounds
    if method.endswith("+vt"):
        want["vt_kl_loss_fwd"] = want["vt_kl_loss_bwd"] = \
            rounds * exp.train.steps_per_round
    if method == "fedavg":
        want["neighbor_avg"] = rounds
    if exp.layout == "dense" and exp.comm is not None \
            and exp.comm.use_per_edge:
        want["gather_rows"] = rounds
    if exp.comm is not None:
        want["drift_norms"] = rounds
    return want


def l_run(torch, ops, exp, rounds=L_ROUNDS, mode=None, verbose=False):
    """`rounds` rounds, each evaluated, with every launch count set to 0
    just before and read just after: ms per round and the launches."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = exp.run(rounds=rounds, eval_every=1, mode=mode, verbose=verbose)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / rounds
    return dict(hist=hist, ms=ms, launches=dict(ops.LAUNCHES))


def l_state(torch, exp, hist):
    """What path l holds two runs to, bitwise: params, optimizer and
    transport state, bytes, every history, accuracies and detail."""
    from repro_torch.utils.pytree import tree_leaves

    comm = ([] if exp.comm_state is None
            else tree_leaves(exp.comm_state._asdict()))
    return dict(
        tensors=[t.clone() for t in tree_leaves(exp.params)
                 + tree_leaves(exp.opt_state)],
        comm=[t.clone() for t in comm],
        bytes=exp.comm_bytes_total, trig=list(exp.trig_history),
        live=list(exp.live_history), sim=list(exp.sim_time_history),
        arrived=list(exp.arrived_history),
        losses=list(exp.train_loss_history),
        acc=[m.acc_per_node.copy() for m in hist],
        detail=[m.detail for m in hist])


def same_state(torch, a, b, detail=False, comm=True):
    """`l_state` snapshots bitwise equal (the transport state only when
    `comm`: its layout differs between the layouts); the detail too when
    `detail`."""
    import numpy as np

    keys = ("tensors", "comm") if comm else ("tensors",)
    ok = all(len(a[k]) == len(b[k]) and all(
        torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in keys)
    ok = ok and all(a[k] == b[k] for k in ("bytes", "trig", "live", "sim",
                                           "arrived", "losses"))
    ok = ok and len(a["acc"]) == len(b["acc"]) and all(
        np.array_equal(x, y) for x, y in zip(a["acc"], b["acc"]))
    if detail:
        ok = ok and all(
            list(x) == list(y) and all(np.array_equal(x[k], y[k])
                                       for k in x)
            for x, y in zip(a["detail"], b["detail"]))
    return ok


def l_detail_checks(hist, label):
    """Per eval round: Σ edge_bytes == bytes_on_wire exactly, node_acc ==
    acc_per_node."""
    import numpy as np

    for m in hist:
        d = m.detail
        if "edge_bytes" in d:
            check(float(np.sum(d["edge_bytes"])) == m.bytes_on_wire,
                  f"{label}: round {m.round} edge bytes "
                  f"{float(np.sum(d['edge_bytes']))} != {m.bytes_on_wire}")
        check(np.array_equal(d["node_acc"], m.acc_per_node),
              f"{label}: round {m.round} node_acc != acc_per_node")
        for k, v in d.items():
            check(bool(np.isfinite(v).all()), f"{label}: {k} not finite")


def path_l(torch, ops, dev, world):
    """Telemetry on a-c's world at full width (l0-l2 and the profile
    directory; see the module docstring).  Returns each run's summary."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np

    from repro_torch.comm import CommConfig
    from repro_torch.dynamics import EnergyChurn
    from repro_torch.engine import Experiment, Schedule
    from repro_torch.obs import (CHANNELS, Telemetry, export_trace,
                                 format_round, read_ledger, validate_ledger)
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    shutil.rmtree(L_DIR, ignore_errors=True)
    L_DIR.mkdir(parents=True)
    clock = Timing(LognormalStep(**K_NODE), LognormalLink(**K_LINK))
    edge_int8 = CommConfig(codec="int8", policy="adaptive",
                           target_trigger=0.95)
    out = {}

    def build(tele, layout=None, mode="fused", comm=edge_int8,
              dynamics=None, method="decdiff+vt", deadline=K_DEADLINE):
        w = dataclasses.replace(world, timing=clock, dynamics=dynamics,
                                telemetry=tele)
        exp = Experiment(w, method, comm=comm, layout=layout,
                         schedule=Schedule(rounds=L_ROUNDS, eval_every=1,
                                           mode=mode, deadline=deadline))
        exp.run(rounds=1, eval_every=1)  # warm round
        return exp

    # -- l0: every channel, dense, fused, against telemetry=None --------
    ledger = str(L_DIR / "l0.jsonl")
    off = build(None)
    on = build(Telemetry(channels="all", ledger=ledger))
    ms = {"off": [], "on": []}
    first = None
    for turn, (key, exp) in enumerate([("off", off), ("on", on),
                                       ("off", off), ("on", on)]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = l_run(torch, ops, exp, verbose=turn == 3)
        ms[key].append(r["ms"])
        want = l_expected_launches(ops, exp, "decdiff+vt", L_ROUNDS)
        check(r["launches"] == want,
              f"path l0 ({key}): launches {r['launches']}, not {want}")
        if turn == 1:
            first = l_state(torch, on, r["hist"])
            hist_on = r["hist"]
        if turn == 3:
            lines = buf.getvalue().splitlines()
            check(lines == [format_round("decdiff+vt", m)
                            for m in r["hist"]],
                  f"path l0: verbose lines {lines}")
            print("path l0 verbose lines (run(verbose=True)):")
            for line in lines:
                print(f"  {line}")
    same = same_state(torch, l_state(torch, off, []), l_state(torch, on, []))
    print(f"path l0 (Telemetry(channels='all'), per-edge int8 adaptive "
          f"0.95, LognormalStep + LognormalLink at 1e6 B/s, deadline "
          f"{K_DEADLINE} s, dense, fused; off, on, off, on, {L_ROUNDS} "
          f"rounds each after a warm round): params, optimizer and "
          f"transport state, bytes, trigger, simulated seconds and arrived "
          f"histories bitwise equal to telemetry=None = {same}; launches "
          f"equal = True; ms per round off {ms['off']}, on {ms['on']}, "
          f"ratio on/off {sum(ms['on']) / sum(ms['off']):.4f}")
    check(same, "path l0: telemetry changed the run")
    check(on.bound_obs.channels == tuple(CHANNELS),
          f"path l0 channels {on.bound_obs.channels}")
    l_detail_checks(hist_on, "path l0")
    d = hist_on[-1].detail
    print(f"path l0 detail after round {hist_on[-1].round} of the first "
          f"measured run: " + "; ".join(
              f"{k} {v.shape} [{float(v.min()):.6g}, {float(v.max()):.6g}]"
              for k, v in d.items()))
    counts = validate_ledger(ledger)
    manifest, _, summaries = read_ledger(ledger)
    check(counts == {"manifest": 1, "round": 1 + 2 * L_ROUNDS,
                     "summary": 3} and "jax" not in manifest["env"]
          and manifest["env"]["device_type"] == "cuda"
          and len(manifest["edges"]["src"]) == manifest["num_directed"],
          f"path l0 ledger: {counts}, env {manifest['env']}")
    print(f"path l0 ledger: {counts} (one summary per run() call: the warm "
          f"round and two measured runs), env {manifest['env']}, summaries "
          f"rounds per second "
          f"{[round(s['rounds_per_sec'], 3) for s in summaries]}")
    trace = export_trace(on, str(L_DIR / "l0_trace.json"))
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    edge = [e for e in spans if e["pid"] == 1]
    late = sum(1 for e in edge if not e["args"]["arrived"])
    span_bytes = sum(e["args"]["bytes"] for e in edge)
    print(f"path l0 trace: {len(spans)} spans ({len(spans) - len(edge)} "
          f"train, {len(edge)} transfers, {late} late), span bytes "
          f"{span_bytes:.0f}, bytes on the wire {on.comm_bytes_total:.0f}")
    check(span_bytes == on.comm_bytes_total and late > 0,
          f"path l0 trace: span bytes {span_bytes} != "
          f"{on.comm_bytes_total} or no late payload ({late})")
    out["l0"] = dict(ms_off=ms["off"], ms_on=ms["on"],
                     launches=r["launches"], counts=counts,
                     late=late, spans=len(spans))
    del off, on

    # -- l1: l0 on the sparse layout, and l0 in loop mode ---------------
    for key, layout, mode in (("l1_sparse", "sparse", "fused"),
                              ("l1_loop", "dense", "loop")):
        exp = build(Telemetry(channels="all"), layout=layout, mode=mode)
        r = l_run(torch, ops, exp, mode=mode)
        want = l_expected_launches(ops, exp, "decdiff+vt", L_ROUNDS)
        check(r["launches"] == want,
              f"path {key}: launches {r['launches']}, not {want}")
        same = same_state(torch, first, l_state(torch, exp, r["hist"]),
                          detail=True, comm=layout == "dense")
        print(f"path {key} ({layout}, {mode}): {r['ms']:.2f} ms per round; "
              f"params, histories and every round's detail bitwise l0's = "
              f"{same}; launches {r['launches']}")
        check(same, f"path {key}: differs from l0")
        out[key] = dict(ms=r["ms"], launches=r["launches"])
        del exp

    # -- l2: per-node int8 with a trigger and fedavg under EnergyChurn ---
    churn = EnergyChurn(capacity=8.0, recharge=4.0, rejoin_at=4.0)
    for key, method, comm, tele in [
            ("l2", "decdiff+vt",
             CommConfig(codec="int8", trigger_threshold=0.8), "all"),
            ("l2_fedavg", "fedavg", None, "auto")]:
        pair = {}
        for k in ("off", "on"):
            exp = build(None if k == "off" else Telemetry(channels=tele),
                        comm=comm, dynamics=churn, method=method,
                        deadline=None)
            alive = []
            inner = exp.bound_dyn.transition

            def transition(*args, inner=inner, alive=alive):
                state, ev = inner(*args)
                alive.append(ev.alive.cpu().numpy())
                return state, ev

            object.__setattr__(exp.bound_dyn, "transition", transition)
            r = l_run(torch, ops, exp)
            want = l_expected_launches(ops, exp, method, L_ROUNDS)
            check(r["launches"] == want,
                  f"path {key} ({k}): launches {r['launches']}, not {want}")
            pair[k] = (exp, r, alive)
        (eoff, roff, _), (eon, ron, alive) = pair["off"], pair["on"]
        same = same_state(torch, l_state(torch, eoff, roff["hist"]),
                          l_state(torch, eon, ron["hist"]))
        l_detail_checks(ron["hist"], f"path {key}")
        hist_obs = eon.obs_history[-len(alive) - 1:]
        steps = np.diff(np.stack([s["node_steps"] for s in hist_obs]),
                        axis=0)
        secs = np.diff(np.stack([s["node_secs"] for s in hist_obs]), axis=0)
        dead = np.stack(alive) == 0
        frozen = bool((steps[dead] == 0).all() and (secs[dead] == 0).all())
        print(f"path {key} (EnergyChurn(8, 4, 4), LognormalStep + "
              f"LognormalLink at 1e6 B/s, {method}"
              + (", per-node int8 trigger 0.8" if comm else "")
              + f", channels={tele!r}): ms per round off {roff['ms']:.2f}, "
              f"on {ron['ms']:.2f}; bitwise equal to telemetry=None = "
              f"{same}; node-rounds dead {int(dead.sum())}, a dead node's "
              f"node_steps and node_compute unchanged = {frozen}; "
              f"triggered {eon.trig_history[-L_ROUNDS:]}")
        check(same, f"path {key}: telemetry changed the run")
        check(dead.any() and frozen, f"path {key}: dead {int(dead.sum())}, "
                                     f"frozen {frozen}")
        out[key] = dict(ms_off=roff["ms"], ms_on=ron["ms"],
                        launches=ron["launches"], dead=int(dead.sum()))
        del pair, eoff, eon

    # -- Telemetry(profile_dir=...): a trace file, results unchanged -----
    prof_dir = L_DIR / "profile"
    exp = build(Telemetry(channels="all", profile_dir=str(prof_dir)))
    r = l_run(torch, ops, exp)
    same = same_state(torch, first, l_state(torch, exp, r["hist"]),
                      detail=True)
    files = sorted(p.name for p in prof_dir.iterdir())
    size = sum((prof_dir / f).stat().st_size for f in files)
    print(f"path l profile_dir: {len(files)} trace files ({size} B) "
          f"{files}; results bitwise l0's = {same}; launches "
          f"{r['launches']}")
    check(same and len(files) == 2 and all(f.endswith(".json")
                                           for f in files),
          f"path l profile_dir: files {files}, same {same}")
    out["l_profile"] = dict(launches=r["launches"], files=len(files))
    del exp
    gc.collect()
    return out


def path_l3(torch, ops, world):
    """l3: path h's 256-node sparse world, `channels="auto"` with h's
    per-edge transport, 2 rounds each way: peak memory on and off."""
    import dataclasses

    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, Schedule
    from repro_torch.obs import Telemetry

    runs = {}
    for key in ("off", "on"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exp = Experiment(
            dataclasses.replace(world, telemetry=None if key == "off"
                                else Telemetry(channels="auto")),
            "decdiff+vt", layout="sparse",
            comm=CommConfig(codec="int8", policy="adaptive",
                            target_trigger=0.95),
            schedule=Schedule(rounds=2, eval_every=1))
        exp.run(rounds=1, eval_every=1)  # warm round
        r = l_run(torch, ops, exp, rounds=2)
        peak = torch.cuda.max_memory_allocated()
        want = l_expected_launches(ops, exp, "decdiff+vt", 2)
        check(r["launches"] == want,
              f"path l3 ({key}): launches {r['launches']}, not {want}")
        runs[key] = dict(r, exp=exp, peak=peak, rise=peak - base,
                         state=l_state(torch, exp, r["hist"]))
    on, off = runs["on"], runs["off"]
    same = same_state(torch, off["state"], on["state"])
    l_detail_checks(on["hist"], "path l3")
    chans = on["exp"].bound_obs.channels
    print(f"path l3 ({H_NODES} nodes, sparse, per-edge int8 adaptive 0.95, "
          f"channels='auto' = {list(chans)}): ms per round off "
          f"{off['ms']:.2f}, on {on['ms']:.2f}; peak device memory off "
          f"{off['peak']} B ({off['rise']} B above the run's start), on "
          f"{on['peak']} B ({on['rise']} B above the run's start), on - off "
          f"rise {(on['rise'] - off['rise']) / 2**30:.3f} GiB; bitwise equal "
          f"to telemetry=None = {same}")
    check(same, "path l3: telemetry changed the run")
    out = {k: dict(ms=v["ms"], peak=v["peak"], rise=v["rise"],
                   launches=v["launches"]) for k, v in runs.items()}
    del runs, on, off
    gc.collect()
    return out


def path_l4(torch, ops, world, make_exp):
    """l4: path i's 10^4-node world with i1's transport and
    `channels="auto"`, without and with a ledger: rounds per second in
    turns against telemetry=None (off, on, ledger, off, on, ledger), and
    a manifest without edges (39,964 directed edges exceed
    MANIFEST_EDGE_CAP)."""
    import dataclasses

    from repro_torch.obs import MANIFEST_EDGE_CAP, Telemetry, read_ledger

    ledger = str(L_DIR / "l4.jsonl")
    tele = {"off": None, "on": Telemetry(channels="auto"),
            "ledger": Telemetry(channels="auto", ledger=ledger)}
    exps = {}
    for key, t in tele.items():
        exps[key] = make_exp(dataclasses.replace(world, telemetry=t))
        exps[key].run()  # warm run
    rps = {key: [] for key in tele}
    launches_on = dict.fromkeys(ops.LAUNCHES, 0)
    for key in ("off", "on", "ledger") * 2:
        exp = exps[key]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = exp.run()
        torch.cuda.synchronize()
        rps[key].append(ROUNDS / (time.perf_counter() - t0))
        want = l_expected_launches(ops, exp, "decdiff", ROUNDS)
        check(dict(ops.LAUNCHES) == want,
              f"path l4 ({key}): launches {dict(ops.LAUNCHES)}, not {want}")
        if key != "off":
            l_detail_checks(hist, f"path l4 ({key})")
            for k, v in ops.LAUNCHES.items():
                launches_on[k] += v
    off = l_state(torch, exps["off"], [])
    same = all(same_state(torch, off, l_state(torch, exps[k], []))
               for k in ("on", "ledger"))
    manifest, rounds, _ = read_ledger(ledger)
    n_dir = manifest["num_directed"]
    print(f"path l4 ({I_NODES} nodes, sparse, decdiff, per-edge int8 "
          f"adaptive 0.6, channels='auto' = "
          f"{list(exps['on'].bound_obs.channels)}, loop): rounds per second "
          f"off {rps['off']}, on {rps['on']}, on with the ledger "
          f"{rps['ledger']}; ratios to off "
          f"{sum(rps['on']) / sum(rps['off']):.4f} / "
          f"{sum(rps['ledger']) / sum(rps['off']):.4f}; bitwise equal to "
          f"telemetry=None = {same}; manifest num_directed {n_dir} > "
          f"MANIFEST_EDGE_CAP {MANIFEST_EDGE_CAP}: edges in the manifest = "
          f"{'edges' in manifest}; {len(rounds)} round records")
    check(same, "path l4: telemetry changed the run")
    check(n_dir > MANIFEST_EDGE_CAP and "edges" not in manifest,
          f"path l4 manifest: {n_dir} edges, keys {sorted(manifest)}")
    del exps
    gc.collect()
    return dict(rps_off=rps["off"], rps_on=rps["on"],
                rps_ledger=rps["ledger"], launches=launches_on)


# ----------------------------------------------------------------- path j

M_DIR = ROOT / "build" / "path_m"     # path m's rendezvous and results
M_PODS = 2                            # m1 / m2: gloo ranks on the one card
M2_ROUNDS = 3                         # m2's measured rounds (after a warm one)
# path m's runs: (method, CommConfig kwargs or None, layout)
M_RUNS = {
    "decdiff+vt": ("decdiff+vt", dict(codec="int8", policy="adaptive",
                                      target_trigger=0.95), "dense"),
    "decdiff+vt_s": ("decdiff+vt", dict(codec="int8", policy="adaptive",
                                        target_trigger=0.95), "sparse"),
    "fedavg": ("fedavg", None, "dense"),
    "cfa-ge": ("cfa-ge", None, "dense"),
}
M0_RUNS = ("decdiff+vt", "decdiff+vt_s")


def m_experiment(world, key, backend, device=None):
    """One run of path m on a-c's world: `EdgeDropout(0.2)`, path k's
    clock with its 6 s deadline and every channel the run supports
    (`Telemetry("all")` with the transport), fused, eval every round."""
    import dataclasses

    from repro_torch.comm import CommConfig
    from repro_torch.dynamics import EdgeDropout
    from repro_torch.engine import Experiment, Schedule
    from repro_torch.obs import Telemetry
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    method, comm, layout = M_RUNS[key]
    w = dataclasses.replace(
        world, dynamics=EdgeDropout(p=0.2),
        timing=Timing(LognormalStep(**K_NODE), LognormalLink(**K_LINK)),
        telemetry=Telemetry("all" if comm is not None else "auto"))
    return Experiment(w, method, backend=backend, layout=layout,
                      comm=None if comm is None else CommConfig(**comm),
                      schedule=Schedule(rounds=ROUNDS, eval_every=1,
                                        deadline=K_DEADLINE), device=device)


def m_digest(exp, hist):
    """What path m holds two runs to, bitwise and picklable: params (kept
    whole, for a measured gap), sha256 of the optimizer and transport
    state and of every channel snapshot, and every history."""
    import hashlib

    import numpy as np

    from repro_torch.utils.pytree import tree_leaves

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    comm = ([] if exp.comm_state is None
            else [v for v in exp.comm_state if v is not None])
    return dict(
        params=[t.cpu().numpy() for t in tree_leaves(exp.params)],
        opt=[sha(t.cpu().numpy()) for t in tree_leaves(exp.opt_state)],
        comm=[sha(t.cpu().numpy()) for t in comm],
        obs=[{k: sha(v) for k, v in o.items()} for o in exp.obs_history],
        detail=[{k: sha(v) for k, v in m.detail.items()} for m in hist],
        acc=[m.acc_per_node.tolist() for m in hist],
        bytes=exp.comm_bytes_total, trig=list(exp.trig_history),
        live=list(exp.live_history), sim=list(exp.sim_time_history),
        arrived=list(exp.arrived_history),
        losses=list(exp.train_loss_history))


def m_compare(a, b):
    """(bitwise equal, the largest |param| difference, the largest train
    loss difference, what differs) of two `m_digest`s; a channel that
    differs is named as "obs:<channel>" or "detail:<channel>"."""
    import numpy as np

    gap = max(float(np.max(np.abs(x - y))) for x, y in
              zip(a["params"], b["params"]))
    differ = [] if gap == 0.0 and all(
        np.array_equal(x, y) for x, y in zip(a["params"], b["params"])) \
        else ["params"]
    for k in ("opt", "comm", "acc", "bytes", "trig", "live", "sim",
              "arrived"):
        if a[k] != b[k]:
            differ.append(k)
    for k in ("obs", "detail"):
        if len(a[k]) != len(b[k]):
            differ.append(k)
            continue
        differ += sorted({f"{k}:{c}" for x, y in zip(a[k], b[k])
                          for c in set(x) | set(y) if x.get(c) != y.get(c)})
    loss_gap = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    return not differ, gap, loss_gap, differ


def m_drive(torch, ops, exp):
    """One warm round, then ROUNDS rounds with every launch count set to 0
    just before and read just after: the digest, ms per round, launches."""
    exp.run(rounds=1, eval_every=1)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = exp.run(rounds=ROUNDS, eval_every=1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
    launches = dict(ops.LAUNCHES)
    for m in hist:
        check(all(math.isfinite(x) for x in m.acc_per_node),
              f"path m: accuracies {m.acc_per_node}")
    return dict(digest=m_digest(exp, hist), ms=ms, launches=launches)


def m_gather_ms(torch, exp):
    """One more round with the pod context's gather timed (synchronized
    before and after each call, so this round is not a measured one):
    (gather ms in the round, bytes gathered by this rank, calls)."""
    from repro_torch.engine import backends

    inner, spent = exp.pod_ctx.gather, []

    def gather(a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(a)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0, a.numel() * a.element_size()))
        return out

    exp.pod_ctx = exp.pod_ctx._replace(gather=gather)
    exp._round = backends.build_round(exp)
    exp.run(rounds=1, eval_every=1)
    torch.cuda.synchronize()
    exp.pod_ctx = exp.pod_ctx._replace(gather=inner)
    return (1e3 * sum(t for t, _ in spent), sum(b for _, b in spent),
            len(spent))


def lm_node_digests(torch, params):
    """sha256 of each node's params (its leaves' bytes in flat order)."""
    import hashlib

    from repro_torch.utils.pytree import tree_leaves

    leaves = tree_leaves(params)
    out = []
    for i in range(leaves[0].shape[0]):
        h = hashlib.sha256()
        for t in leaves:
            row = t[i].contiguous()
            if row.dtype == torch.bfloat16:
                row = row.view(torch.int16)
            h.update(row.cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def m2_pod_round(torch, ops, dev, mesh, rank, n_pods):
    """Path d's round at P pods: this rank's LM_NODES / P nodes of path
    d's init and batches, one warm round and M2_ROUNDS measured ones, the
    gathers inside them timed (the gloo gather copies through the host,
    which synchronizes anyway).  Returns the block's node digests, losses,
    ms per round, gather ms per round, launches and peak memory."""
    from repro_torch.comm import transport
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_map

    r = LM_NODES // n_pods
    rows = slice(rank * r, (rank + 1) * r)
    lm = build_lm(get_config(LM_ARCH))
    params = tree_map(lambda t: t[rows].clone(),
                      init_nodes(lm, LM_NODES, dev))
    torch.cuda.empty_cache()
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    codec = Int8Codec(stochastic=False)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(LM_NODES), mesh,
                                   loss_kind="vt", beta=LM_BETA, codec=codec)
    batches = [{k: v[rows] for k, v in b.items()} for b in make_batches(
        lm, LM_NODES, LM_BATCH, LM_SEQ, 1 + M2_ROUNDS, dev)]
    params, state, loss = rnd(params, state, 0, batches[0])
    torch.cuda.synchronize()
    inner, spent = transport.all_gather_rows, []

    def timed_gather(a, group, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(a, group, n)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0, a.numel() * a.element_size(),
                      tuple(out.shape)))
        return out

    transport.all_gather_rows = timed_gather
    ops.reset_launches()
    ms, losses, gather_ms = [], [], []
    try:
        for k in range(1, M2_ROUNDS + 1):
            spent.clear()
            t0 = time.perf_counter()
            params, state, loss = rnd(params, state, k, batches[k])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
            gather_ms.append(1e3 * sum(t for t, _, _ in spent))
    finally:
        transport.all_gather_rows = inner
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check((LM_NODES, LM_PARAMS) in [shape for _, _, shape in spent],
          f"path m2: gathered {[shape for _, _, shape in spent]}")
    return dict(digests=lm_node_digests(torch, params), losses=losses,
                ms=ms, launches=launches, peak=peak, gather_ms=gather_ms,
                gather_bytes=[b for _, b, _ in spent])


def m_worker(rank, n_pods, out_dir):
    """One gloo rank of paths m1 and m2, on the one card (cuda:0): m1's
    runs, then m2's LM pod round; results pickled to
    `out_dir/rank<r>.pkl`."""
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.engine import World
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    store = dist.FileStore(str(Path(out_dir) / "store"), n_pods)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=n_pods)
    try:
        out = {"m1": {}}
        world = World.synthetic("synth-mnist", nodes=16,
                                topology="barabasi_albert", m=2, scale=1.0)
        for key in M_RUNS:
            exp = m_experiment(world, key, "shard_map")
            check(exp.n_pods == n_pods and exp.pod == rank,
                  f"path m1: pod {exp.pod} of {exp.n_pods}")
            r = m_drive(torch, ops, exp)
            r["gather"] = m_gather_ms(torch, exp)
            out["m1"][key] = r
            del exp
            gc.collect()
        del world
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = init_device_mesh("cuda", (n_pods,), mesh_dim_names=("pod",))
        out["m2"] = m2_pod_round(torch, ops, dev, mesh, rank, n_pods)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def path_m(torch, ops, dev, world, ms_a):
    """The pod backend (see the module docstring): m0 in this process over
    NCCL at world size 1, then m1 and m2 in M_PODS gloo ranks on the card.
    Returns each run's summary; m2's check against path d's round comes
    after path d."""
    import pickle
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    out = {}
    vmap = {}
    # -- m0: shard_map on NCCL at world size 1, against vmap, both layouts
    if M_DIR.exists():
        shutil.rmtree(M_DIR)
    M_DIR.mkdir(parents=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(M_DIR / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        for key in M0_RUNS:
            ref = m_drive(torch, ops, m_experiment(world, key, "vmap"))
            vmap[key] = ref
            exp = m_experiment(world, key, "shard_map")
            check(exp.n_pods == 1 and dist.get_backend() == "nccl",
                  f"path m0: {exp.n_pods} pods")
            got = m_drive(torch, ops, exp)
            got["gather"] = m_gather_ms(torch, exp)
            same, gap, loss_gap, differ = m_compare(got["digest"],
                                                    ref["digest"])
            print(f"path m0 ({key}, shard_map on NCCL, world size 1): "
                  f"{got['ms']:.2f} ms per round (vmap {ref['ms']:.2f}, path "
                  f"a {ms_a:.2f}); gather {got['gather'][0]:.3f} ms, "
                  f"{got['gather'][1]} B in {got['gather'][2]} calls a "
                  f"round; launches {got['launches']}; bitwise vmap = "
                  f"{same} (params gap {gap}, loss gap {loss_gap})")
            check(same and loss_gap == 0.0,
                  f"path m0 ({key}) differs from vmap: {differ}, params "
                  f"gap {gap}")
            check(got["launches"] == ref["launches"],
                  f"path m0 ({key}): launches {got['launches']} against "
                  f"vmap's {ref['launches']}")
            out[f"m0_{key}"] = got
            del exp
            gc.collect()
    finally:
        dist.destroy_process_group()
    # the vmap side of m1's other runs, in this process
    for key in M_RUNS:
        if key not in vmap:
            vmap[key] = m_drive(torch, ops, m_experiment(world, key, "vmap"))
    gc.collect()
    torch.cuda.empty_cache()
    # -- m1 and m2: M_PODS gloo ranks on this card, one spawn
    t0 = time.perf_counter()
    mp.spawn(m_worker, args=(M_PODS, str(M_DIR)), nprocs=M_PODS, join=True)
    ranks = []
    for r in range(M_PODS):
        with open(M_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    print(f"path m1 + m2: {M_PODS} gloo ranks on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    for key in M_RUNS:
        ref = vmap[key]
        runs = [rk["m1"][key] for rk in ranks]
        same, gap, loss_gap, differ = m_compare(runs[0]["digest"],
                                                ref["digest"])
        agree = all(m_compare(x["digest"], runs[0]["digest"])[0]
                    for x in runs[1:])
        launches = {k: sum(x["launches"][k] for x in runs)
                    for k in ops.LAUNCHES}
        # every launch is per call, so each rank launches as the vmap run
        share = all(x["launches"] == ref["launches"] for x in runs)
        print(f"path m1 ({key}, {M_PODS} pods over gloo on one card): ms per "
              f"round {[round(x['ms'], 2) for x in runs]} (vmap "
              f"{ref['ms']:.2f}); gather ms a round "
              f"{[round(x['gather'][0], 3) for x in runs]} "
              f"({runs[0]['gather'][1]} B from each rank in "
              f"{runs[0]['gather'][2]} calls, through host memory); "
              f"launches (both ranks) {launches}, each rank's = vmap's "
              f"{share}; bitwise vmap = {same} (params gap {gap}, loss gap "
              f"{loss_gap}, differ {differ}); ranks agree = {agree}")
        check(same, f"path m1 ({key}) differs from vmap: {differ}, params "
                    f"gap {gap}")
        check(loss_gap <= 1e-6, f"path m1 ({key}) loss gap {loss_gap}")
        check(agree, f"path m1 ({key}): the ranks' results differ")
        check(share, f"path m1 ({key}): launches by rank "
                     f"{[x['launches'] for x in runs]} against vmap's "
                     f"{ref['launches']}")
        out[f"m1_{key}"] = dict(ms=[x["ms"] for x in runs],
                                gather=[x["gather"] for x in runs],
                                launches=launches, vmap_ms=ref["ms"])
    m2 = [rk["m2"] for rk in ranks]
    check(m2[0]["losses"] == m2[1]["losses"],
          f"path m2: the ranks' losses {[x['losses'] for x in m2]}")
    out["m2"] = dict(digests=sum((x["digests"] for x in m2), []),
                     losses=m2[0]["losses"],
                     ms=[x["ms"] for x in m2],
                     gather_ms=[x["gather_ms"] for x in m2],
                     gather_bytes=m2[0]["gather_bytes"],
                     peak=[x["peak"] for x in m2],
                     launches={k: sum(x["launches"][k] for x in m2)
                               for k in ops.LAUNCHES})
    lm = out["m2"]["launches"]
    print(f"path m2 (qwen1.5-0.5b 4-node ring, fused int8, {M_PODS} pods of "
          f"2 nodes over gloo): ms per round {out['m2']['ms']} (median by "
          f"rank {[statistics.median(x) for x in out['m2']['ms']]}), of which "
          f"the gathers {out['m2']['gather_ms']} ms "
          f"({out['m2']['gather_bytes']} B from each rank), peak "
          f"{out['m2']['peak']} B per rank, losses {out['m2']['losses']}, "
          f"launches (both ranks) {lm}")
    check(lm["dequant_neighbor_avg_rows"] == M_PODS * M2_ROUNDS
          and lm["decdiff_update"] == M_PODS * M2_ROUNDS
          and lm["vt_kl_loss_fwd"] == lm["vt_kl_loss_bwd"]
          == LM_NODES * M2_ROUNDS, f"path m2: launches {lm}")
    out["launches"] = {
        "m0": {k: sum(out[f"m0_{key}"]["launches"][k] for key in M0_RUNS)
               for k in ops.LAUNCHES},
        "m1": {k: sum(out[f"m1_{key}"]["launches"][k] for key in M_RUNS)
               for k in ops.LAUNCHES},
        "m2": lm}
    return out


def timed_rounds(torch, ops, exp, label, rounds=ROUNDS):
    """One warm round, then `rounds` fused rounds, each evaluated, with
    every launch count set to 0 just before and read just after and the
    peak device memory taken over them.  A round's time runs from its
    start to the next round's start (its evaluation included): the round
    function is wrapped to synchronize and read the clock as it starts.
    Returns (history, launches, [ms per round], peak bytes)."""
    exp.run(rounds=1, eval_every=1)  # warm round
    torch.cuda.synchronize()
    inner, starts = exp._round, []

    def clocked(*args):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return inner(*args)

    exp._round = clocked
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        history = exp.run(rounds=rounds, eval_every=1)
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
    finally:
        exp._round = inner
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = [1e3 * (b - a) for a, b in zip(starts[:-1], starts[1:])]
    losses = exp.train_loss_history[-rounds:]
    check_history(torch, exp, history, losses, label)
    print(f"{label}: {rounds} rounds (fused, eval every round) ms per round "
          f"{', '.join(f'{x:.2f}' for x in ms)} (median "
          f"{statistics.median(ms):.2f}), peak device memory "
          f"{peak / 2**30:.2f} GiB, final accuracy mean "
          f"{history[-1].acc_mean:.4f} std {history[-1].acc_std:.4f}, train "
          f"losses {[round(x, 5) for x in losses]}; kernel launches "
          f"{launches}")
    return history, launches, ms, peak


def j_expected_launches(ops, method, steps):
    """The Table II roster's launches over ROUNDS rounds: the segment
    reduce (B.1) once a round on the gossip methods, Eq. 5 (B.2) once a
    round on decdiff*, the VT loss (B.3) forward and backward once a local
    step on decdiff+vt, `neighbor_avg` (B.6) once a round on fedavg, and
    nothing else."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if method in ("dechetero", "cfa", "cfa-ge", "decdiff", "decdiff+vt"):
        want["segment_neighbor_avg"] = ROUNDS
    if method.startswith("decdiff"):
        want["decdiff_update"] = ROUNDS
    if method.endswith("+vt"):
        want["vt_kl_loss_fwd"] = want["vt_kl_loss_bwd"] = ROUNDS * steps
    if method == "fedavg":
        want["neighbor_avg"] = ROUNDS
    return want


def real_logits(torch, exp):
    """Every node's logits on its own batch of the last round's first local
    step, [N·B, classes], and the labels: B.3's real inputs."""
    xb, yb = exp.batcher.take(exp.x_pad, exp.y_pad, exp.counts, 0)
    with torch.no_grad():
        z = exp.model.apply(exp.params, xb)
    return z.reshape(-1, z.shape[-1]).contiguous(), yb.reshape(-1)


def cnn_oracles(torch, dev):
    """The port's bitwise oracles on the card with the full-width CNN, on a
    16-node world: `decdiff+vt` (Fashion) fused equals loop and the sparse
    layout equals dense; with dropout (EMNIST), `decdiff+vt` and `cfa-ge`
    (keep masks drawn inside the gradient walk) fused equal loop.  Every
    run is 3 rounds, each evaluated."""
    from repro_torch.engine import Experiment, World
    from repro_torch.utils.pytree import tree_leaves

    def run(world, method, mode, layout=None):
        exp = Experiment(world, method, steps_per_round=2, batch_size=32,
                         lr=0.05, layout=layout)
        hist = exp.run(rounds=3, eval_every=1, mode=mode)
        return ([p.clone() for p in tree_leaves(exp.params)],
                [m.acc_per_node.copy() for m in hist],
                list(exp.train_loss_history))

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                and all((x == y).all() for x, y in zip(a[1], b[1]))
                and a[2] == b[2])

    for dataset, scale, cases in [
            ("synth-fashion", 0.02, [("decdiff+vt", "fused", None),
                                     ("decdiff+vt", "loop", "sparse")]),
            ("synth-emnist", 0.05, [("decdiff+vt", "fused", None),
                                    ("cfa-ge", "fused", None)])]:
        world = World.synthetic(dataset, nodes=16, topology="erdos_renyi",
                                p=0.3, scale=scale)
        for method, mode, layout in cases:
            base = run(world, method, "loop")
            other = run(world, method, mode, layout)
            ok = same(base, other)
            what = (f"{layout} layout equals dense" if layout
                    else f"{mode} equals loop")
            print(f"CNN oracle ({dataset}, 16 nodes, {method}): {what} "
                  f"bitwise (params, accuracies, train losses) = {ok}; "
                  f"final mean accuracy {base[1][-1].mean():.4f}")
            check(ok, f"CNN oracle {dataset} {method}: {what} fails")
            del base, other
        del world
        gc.collect()


def path_j(torch, ops, dev, profile):
    """The paper's Table II / IV path at the Table I CNN's full width (see
    the module docstring).  Returns the roster's and the EMNIST runs'
    launches and ms per round, and the kernel checks at this path's
    shapes."""
    from repro_torch.data.synth import make_dataset
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.fl.metrics import (accuracy_table, characteristic_time,
                                        comm_bytes_per_round)
    from repro_torch.fl.trainer import centralized_train
    from repro_torch.kernels.segment_avg import segment_avg_plain
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.utils.pytree import (tree_bytes, tree_flatten_stacked,
                                          tree_map)

    t_start = t0 = time.perf_counter()
    world = World.synthetic("synth-fashion", nodes=J_NODES,
                            topology="erdos_renyi", p=0.2, seed=0, scale=1.0)
    topo = world.topo
    print(f"path j world built in {time.perf_counter() - t0:.1f} s: "
          f"synth-fashion, {topo.num_nodes} nodes, ER p = 0.2, "
          f"{topo.num_edges} undirected edges, max degree {topo.max_degree}, "
          f"{sum(len(x) for x in world.xs)} / {len(world.x_test)} images")
    check(topo.num_edges == 252 and topo.max_degree == 16
          and sum(len(x) for x in world.xs) == 60000
          and len(world.x_test) == 10000, "path j: the world is not the "
                                          "paper's 50-node ER split")
    sched = Schedule(rounds=ROUNDS, eval_every=1)
    runs, keep = {}, {}
    for method in J_METHODS:
        exp = Experiment(world, method, schedule=sched, **J_TRAIN)
        d = tree_flatten_stacked(exp.params)[0].shape[1]
        check(d == J_PARAMS[10], f"path j: the CNN has {d} params, not "
                                 f"{J_PARAMS[10]}")
        hist, launches, ms, peak = timed_rounds(
            torch, ops, exp, f"path j {method} (synth-fashion, 50 nodes, "
                             f"CNN)")
        want = j_expected_launches(ops, method, exp.train.steps_per_round)
        check(launches == want, f"path j {method}: launches {launches}, "
                                f"want {want}")
        if method == "fedavg":
            mat = tree_flatten_stacked(exp.params)[0]
            check(bool((mat == mat[:1]).all()),
                  "path j fedavg: the nodes' models differ")
            del mat
        runs[method] = dict(history=hist, launches=launches, ms=ms,
                            peak=peak)
        if method in ("fedavg", "decdiff+vt"):
            keep[method] = exp
        else:
            del exp
        gc.collect()
    if profile:
        ex = keep["decdiff+vt"]
        profile_round(torch, lambda: ex.run(rounds=1, eval_every=1),
                      "path j decdiff+vt (50-node CNN, eval included)")

    # -- the kernels at this path's shapes --------------------------------
    ex = keep["decdiff+vt"]
    table = tree_flatten_stacked(ex.params)[0]
    w_j = (ex.nbr_weight * ex.nbr_valid).contiguous()
    vals = table[ex.nbr_idx].contiguous()
    seg = kernel_vs_plain(torch, ops, segment_avg_plain, vals, w_j,
                          "path j (50-node ER CNN, real panel and weights)")
    sums, tot = ops.segment_neighbor_avg(vals, w_j)
    del vals
    torch.cuda.empty_cache()
    avg = sums / torch.clamp(tot, min=1e-30)[:, None]
    eq5 = eq5_vs_plain(torch, table, avg, tot.contiguous(),
                       "path j (real CNN block and its average)",
                       s=ex.train.s)
    del avg, sums
    z, y = real_logits(torch, ex)
    vt = vt_vs_plain(torch, ops, z, y, "path j (real CNN logits, "
                     "synth-fashion)", beta=ex.train.beta)
    fed = keep["fedavg"]
    nav = navg_vs_plain(torch, ops, tree_flatten_stacked(fed.params)[0],
                        fed.agg_state["counts"],
                        "path j (real 50-node CNN stack, |D_i| weights)")
    model_bytes = tree_bytes(tree_map(lambda t: t[0], ex.params))
    del ex, fed, keep, table
    gc.collect()
    torch.cuda.empty_cache()

    # -- the Centralized upper bound, then Tables II and IV ----------------
    ds = make_dataset("synth-fashion", seed=0, scale=1.0)
    t0 = time.perf_counter()
    _, chist = centralized_train(
        world.model, make_optimizer(lr=J_TRAIN["lr"] / 2,
                                    momentum=J_TRAIN["momentum"]),
        ds.x_train, ds.y_train, ds.x_test, ds.y_test, epochs=1,
        batch_size=64, seed=0, eval_every=1)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    c_acc = chist[-1]["acc"]
    print(f"path j centralized (one CNN on all 60,000 images, lr 0.05, batch "
          f"64, 1 epoch = {len(ds.x_train) // 64} steps): {c_s:.2f} s, "
          f"accuracy {c_acc:.4f}, loss {chist[-1]['loss']:.5f}")
    check(0.0 < c_acc <= 1.0 and math.isfinite(chist[-1]["loss"]),
          f"path j centralized: accuracy {c_acc}")
    del ds
    table2 = accuracy_table({m: r["history"] for m, r in runs.items()})
    print(f"path j Table II, a {ROUNDS + 1}-round smoke (one warm round, "
          f"{ROUNDS} measured; not the paper's result, which runs 800 "
          f"rounds), centralized accuracy {c_acc:.4f}:")
    for m, row in table2.items():
        ct = characteristic_time(runs[m]["history"], c_acc)
        cb = comm_bytes_per_round(m, topo, model_bytes)
        print(f"  {m:11s} acc {row['acc_mean']:.4f} ± {row['acc_std']:.4f} "
              f"loss {row['loss_mean']:.4f} (round {row['round']}); Table IV "
              f"rounds to 50/80/90/95% of centralized {list(ct.values())}; "
              f"{cb} bytes per round ({model_bytes} B a model)")
    check(model_bytes == 4 * J_PARAMS[10], f"model bytes {model_bytes}")
    check(comm_bytes_per_round("decdiff+vt", topo, model_bytes)
          == 2 * 252 * model_bytes, "path j: comm bytes per round")

    # -- EMNIST: 26 classes and dropout, in the local steps and the walk ---
    world_e = World.synthetic("synth-emnist", nodes=J_NODES,
                              topology="erdos_renyi", p=0.2, seed=0,
                              scale=1.0)
    emnist, z_e = {}, None
    for method in ("decdiff+vt", "cfa-ge"):
        exp = Experiment(world_e, method, schedule=sched, **J_TRAIN)
        d = tree_flatten_stacked(exp.params)[0].shape[1]
        check(d == J_PARAMS[26], f"path j EMNIST: the CNN has {d} params")
        hist, launches, ms, peak = timed_rounds(
            torch, ops, exp, f"path j {method} (synth-emnist, 50 nodes, CNN "
                             f"with dropout)")
        want = j_expected_launches(ops, method, exp.train.steps_per_round)
        check(launches == want, f"path j EMNIST {method}: launches "
                                f"{launches}, want {want}")
        emnist[method] = dict(launches=launches, ms=ms, peak=peak,
                              acc=hist[-1].acc_mean)
        if method == "decdiff+vt":
            z_e = real_logits(torch, exp)
        del exp
        gc.collect()
    vt_e = vt_vs_plain(torch, ops, *z_e, "path j (real CNN logits, "
                       "synth-emnist)", beta=J_TRAIN["beta"])
    del z_e, world_e, world
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path j took {time.perf_counter() - t_start:.1f} s")
    return dict(runs=runs, emnist=emnist, seg=seg, eq5=eq5, vt=vt,
                vt_emnist=vt_e, nav=nav, central_acc=c_acc,
                central_s=c_s)


def small_lm_agrees(torch, dev):
    """Two fused int8 one-pod rounds of qwen1.5-0.5b reduced to 2 layers,
    d_model 64, vocab 256 (fp32), 4-node ring, on the card and on the CPU
    (the plain versions, which the CPU tests hold against the JAX
    reference): params within 1e-4, loss within 1e-5."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves, tree_map

    lm = build_lm(get_config(LM_ARCH).reduced(n_layers=2, d_model=64,
                                              vocab=256))
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(LM_NODES),
                                   loss_kind="vt", beta=LM_BETA,
                                   codec=Int8Codec(stochastic=False))
    p0 = init_nodes(lm, LM_NODES, "cpu")
    runs = []
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.to(where, copy=True), p0)
        state = opt.init(params)
        losses = []
        for r, b in enumerate(make_batches(lm, LM_NODES, 2, 16, 2, where)):
            params, state, loss = rnd(params, state, r, b)
            losses.append(float(loss))
        runs.append(([t.cpu() for t in tree_leaves(params)], losses))
    (pc, lc), (ph, lh) = runs
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    lerr = max(abs(a - b) for a, b in zip(lc, lh))
    print(f"small LM round (qwen1.5-0.5b reduced: 2 layers, d_model 64, "
          f"vocab 256, fp32; 4 nodes, 2 fused int8 rounds) card vs cpu: max "
          f"|param diff| {perr:.3g}, max |loss diff| {lerr:.3g} (losses card "
          f"{lc}, cpu {lh})")
    check(perr <= 1e-4, f"small LM round: card and cpu params differ by "
                        f"{perr}")
    check(lerr <= 1e-5, f"small LM round: card and cpu losses differ by "
                        f"{lerr}")


def dequant_vs_plain(torch, ops, q, scale, wn, label):
    """Hold `dequant_neighbor_avg_rows` against its plain version (bitwise)
    and time the kernel, the plain version and `ws @ q.float()`."""
    from repro_torch.kernels import dequant_avg as dq

    n, d = q.shape
    r = wn.shape[0]
    out = ops.dequant_neighbor_avg_rows(q, scale, wn)
    torch.cuda.synchronize()
    ws = (wn * scale[None, :]).contiguous()
    ref = dq.dequant_avg_rows_plain(q, ws)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    zero_rows = int((wn.abs().sum(1) == 0).sum())
    zeros_ok = bool((out[wn.abs().sum(1) == 0] == 0).all())
    del out, ref
    t = timings(torch, lambda: dq.dequant_avg_rows_cuda(q, ws),
                lambda: dq.dequant_avg_rows_plain(q, ws),
                lambda: ws @ q.float())
    nbytes = n * d + 4 * (r * n + r * d)
    flops = 2 * r * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"dequant_neighbor_avg_rows {label} [N={n}, R={r}, D={d}, "
          f"{zero_rows} zero weight rows]: torch.equal(kernel, plain)="
          f"{equal} max_abs_err={err:g} "
          f"{timing_text(t, 'ws @ q.float()', bound_ms)}; bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB)")
    check(equal, f"dequant_neighbor_avg_rows {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    check(zeros_ok, f"dequant_neighbor_avg_rows {label}: a zero weight row "
                    f"did not average to zero")
    return dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[n, r, d])


def vt_vs_plain(torch, ops, z, y, label, beta=LM_BETA):
    """Hold the VT loss kernels against their plain versions and time
    kernel, plain version and `F.cross_entropy` with label smoothing
    ε = V(1-β)/(V-1), which puts β on the label and (1-β)/(V-1) elsewhere
    (the same teacher), forward and backward.  Tolerance (the kernels sum
    in another order): per-row KL within 1e-5·|KL| + 1e-5·log V; each
    gradient entry within 1e-5·|ref| (fp32) or one bf16 rounding,
    2^-7·|ref| (bf16), plus min(1e-5·(p + p_t), 1e-6)·|g|: the fp32
    rounding of the two terms whose difference it is, at most 1e-6·|g|.
    The gradient's tolerance is checked to reject the plain backward with
    the teacher's tail a = (1-β)/(V-1) dropped from the wrong classes.
    The forward's per-row KL, max and Σexp must be bitwise equal between
    the call on all rows and calls on blocks of them (a row, a third, the
    rest).  Prints the forward's `vt_plan` and the backward's vector
    width, as the main path's launches took them."""
    import torch.nn.functional as F

    from repro_torch.core.virtual_teacher import teacher_entropy
    from repro_torch.kernels import vt_kl_loss as vt

    b, v = z.shape
    h = float(teacher_entropy(beta, v))
    g = torch.full((b,), 1.0 / b, dtype=torch.float32, device=z.device)
    zr = z.detach().clone().requires_grad_(True)
    kl = ops.vt_kl_loss(zr, y, beta, -h)
    (dz,) = torch.autograd.grad(kl, zr, g)
    torch.cuda.synchronize()
    plan = {"fwd": vt.vt_plan(v, z.dtype, vt._align(zr))._asdict(),
            "bwd": {"vec_bytes": vt.vt_plan(v, z.dtype,
                                            vt._align(zr, dz)).vec_bytes}}
    pk, pm, ps = vt.vt_forward_plain(z, y, beta, -h)
    pdz = vt.vt_backward_plain(z, y, pm, ps, g, beta)
    kl = kl.detach()
    fwd_err = float((kl - pk).abs().max())
    fwd_ok = bool(((kl - pk).abs() <= 1e-5 * pk.abs()
                   + 1e-5 * math.log(v)).all())
    rtol = 2.0 ** -7 if z.dtype == torch.bfloat16 else 1e-5
    a = vt.teacher_tail(beta, v)
    rows = torch.arange(b, device=z.device)
    terms = torch.exp(z.float() - pm[:, None]) / ps[:, None] + a  # p + p_t
    terms[rows, y] += beta - a
    tol = rtol * pdz.float().abs() + torch.clamp(
        1e-5 * terms, max=1e-6) * g.abs()[:, None]
    del terms
    diff = (dz.float() - pdz.float()).abs()
    bwd_err = float(diff.max())
    bwd_ok = bool((diff <= tol).all())
    no_tail = pdz.float() + a * g[:, None]  # a backward that leaves p_t
    no_tail[rows, y] -= a * g               # out of the wrong classes
    tail_caught = not bool(((no_tail.to(z.dtype).float() - pdz.float()).abs()
                            <= tol).all())
    del tol, no_tail
    eps = v * (1.0 - beta) / (v - 1)
    ce_minus_h = float(F.cross_entropy(z, y, label_smoothing=eps)) - h
    del dz, pdz, diff
    # per row bitwise across row splits (a row, a third, the rest)
    whole = vt.vt_forward_cuda(z, y, beta, -h)
    cuts = [0, 1, 1 + b // 3, b]
    parts = [vt.vt_forward_cuda(z[lo:hi], y[lo:hi], beta, -h)
             for lo, hi in zip(cuts, cuts[1:]) if hi > lo]
    split_ok = all(torch.equal(whole[k], torch.cat([p[k] for p in parts]))
                   for k in range(3))
    del whole, parts
    km, ks = vt.vt_forward_cuda(z, y, beta, -h)[1:]
    t_fwd = timings(torch, lambda: vt.vt_forward_cuda(z, y, beta, -h),
                    lambda: vt.vt_forward_plain(z, y, beta, -h),
                    lambda: F.cross_entropy(z, y, label_smoothing=eps))
    zl = z.detach().clone().requires_grad_(True)
    lib_loss = F.cross_entropy(zl, y, label_smoothing=eps)
    t_bwd = timings(torch, lambda: vt.vt_backward_cuda(z, y, km, ks, g, beta),
                    lambda: vt.vt_backward_plain(z, y, pm, ps, g, beta),
                    lambda: torch.autograd.grad(lib_loss, zl,
                                                retain_graph=True))
    del zl, lib_loss
    elt = z.element_size()
    small = 8 * b + 12 * b  # labels in, three fp32 row stats out / in
    out = {}
    for kind, nbytes, ops_per, t, err in [
            ("fwd", b * v * elt + small, 4, t_fwd, fwd_err),
            ("bwd", 2 * b * v * elt + small + 4 * b, 5, t_bwd, bwd_err)]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops_per * b * v / FP32_FLOPS
        out[kind] = dict(t, bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         max_abs_err=err, shape=[b, v], dtype=str(z.dtype),
                         plan=plan[kind])
        lib = ("F.cross_entropy(label_smoothing)"
               + (" backward" if kind == "bwd" else ""))
        print(f"vt_kl_loss_{kind} {label} [B={b}, V={v}, {z.dtype}], plan "
              f"{plan[kind]}: "
              f"max_abs_err={err:g} "
              f"{timing_text(t, lib, out[kind]['bound_ms'])}; bound "
              f"{out[kind]['bound_ms']:.4f} ms ({out[kind]['bound_by']})")
    print(f"  mean KL {float(kl.mean()):.6f}, plain {float(pk.mean()):.6f}, "
          f"cross_entropy(label_smoothing) - H(p_t) {ce_minus_h:.6f}")
    check(fwd_ok, f"vt_kl_loss_fwd {label}: kernel and plain differ by "
                  f"{fwd_err:g}")
    check(bwd_ok, f"vt_kl_loss_bwd {label}: kernel and plain differ by "
                  f"{bwd_err:g}")
    check(tail_caught, f"vt_kl_loss_bwd {label}: the tolerance passes a "
                       f"backward without the teacher's tail")
    check(split_ok, f"vt_kl_loss_fwd {label}: rows differ between one call "
                    f"and calls on blocks of the rows")
    return out


def eq5_vs_plain(torch, w, avg, row, label, s=1.0):
    """Hold the Eq. 5 kernels against their plain versions on one [R, D]
    block and time each pass.  Pass B must equal the plain step bitwise
    for the kernel's own scale; the per-row Σ(a − x)² within rtol 1e-5 of
    the plain sum (the kernel adds 4096-column block partials in index
    order, the plain sum in PyTorch's order; at D ~ 4.6e8 their fp32
    rounding differs by ~1e-7 relative).  Library: `vector_norm(a − x)`,
    then `x + scale[:, None] * (a − x)`."""
    from repro_torch.kernels import decdiff_update as dd

    r, d = w.shape
    scale, sq = dd.norms_cuda([w], [avg], row, s)
    torch.cuda.synchronize()
    sq_p = dd.sumsq_rows_plain([w], [avg])
    norm_err = float((sq - sq_p).abs().max())
    norm_ok = bool(((sq - sq_p).abs() <= 1e-5 * sq_p.abs()).all())
    out = dd.step_cuda(w, avg, scale)
    torch.cuda.synchronize()
    ref = dd.step_rows_plain(w, avg, scale)
    equal = bool(torch.equal(out, ref))
    step_err = float((out - ref).abs().max())
    gated = (row <= 0)
    gated_ok = bool(torch.equal(out[gated], w[gated]))
    del out, ref
    t_a = timings(torch, lambda: dd.norms_cuda([w], [avg], row, s),
                  lambda: dd.sumsq_rows_plain([w], [avg]),
                  lambda: torch.linalg.vector_norm(avg - w, dim=1))
    t_b = timings(torch, lambda: dd.step_cuda(w, avg, scale),
                  lambda: dd.step_rows_plain(w, avg, scale),
                  lambda: w + scale[:, None] * (avg - w))
    elt = w.element_size()
    res = {}
    for kind, nbytes, flops, t, err in [
            ("sumsq", r * d * (elt + 4) + 4 * r * 3, 3 * r * d, t_a,
             norm_err),
            ("step", r * d * (2 * elt + 4) + 4 * r, 3 * r * d, t_b,
             step_err)]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        res[kind] = dict(t, bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", max_abs_err=err, shape=[r, d],
                         dtype=str(w.dtype))
        print(f"decdiff_update {kind} {label} [R={r}, D={d}, {w.dtype}]: "
              f"max_abs_err={err:g} "
              f"{timing_text(t, 'library', res[kind]['bound_ms'])}; bound "
              f"{res[kind]['bound_ms']:.4f} ms ({res[kind]['bound_by']}, "
              f"{nbytes / 1e9:.3f} GB)")
    print(f"  Σ(a-x)² per row kernel {sq.tolist()}, plain {sq_p.tolist()}; "
          f"scale {scale.tolist()}; pass B torch.equal(kernel, plain)="
          f"{equal}")
    check(norm_ok, f"decdiff_update {label}: norms differ by {norm_err:g}")
    check(equal, f"decdiff_update {label}: pass B != plain step "
                 f"(max_abs_err {step_err:g})")
    check(gated_ok, f"decdiff_update {label}: a gated row moved")
    return res


def drift_vs_plain(torch, x, ref, label):
    """Hold the trigger's drift norms (`ops.drift_norms`: Eq. 5's pass A
    and scale kernel, then the square root) against the plain norms on
    one [R, D] pair: within rtol 1e-5 (another summation order), and the
    first half of the rows bitwise the full call's (a row's sum does not
    depend on R).  Library: `torch.pairwise_distance(x, ref, eps=0)`."""
    from repro_torch.kernels import decdiff_update as dd

    r, d = x.shape
    got = dd.drift_norms_cuda(x, ref)
    half = dd.drift_norms_cuda(x[:max(r // 2, 1)], ref[:max(r // 2, 1)])
    torch.cuda.synchronize()
    plain = dd.drift_norms_plain(x, ref)
    err = float((got - plain).abs().max())
    close = bool(((got - plain).abs() <= 1e-5 * plain.abs()).all())
    blocked = bool(torch.equal(half, got[:max(r // 2, 1)]))
    t = timings(torch, lambda: dd.drift_norms_cuda(x, ref),
                lambda: dd.drift_norms_plain(x, ref),
                lambda: torch.pairwise_distance(x, ref, eps=0.0))
    nbytes, flops = 2 * 4 * r * d + 4 * r, 3 * r * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    res = dict(t, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=err, shape=[r, d])
    print(f"drift_norms {label} [R={r}, D={d}]: max_abs_err={err:g} "
          f"{timing_text(t, 'pairwise_distance', res['bound_ms'])}; bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"{nbytes / 1e9:.3f} GB); half the rows bitwise the full call's "
          f"= {blocked}")
    check(close, f"drift_norms {label}: the norms differ by {err:g}")
    check(blocked, f"drift_norms {label}: a block of rows differs from the "
                   f"full call's")
    return res


def decode_bound_ms(q, k, n_live, out_elems):
    """Least time for one decode attention over the `n_live` slots that
    this run's mask keeps: q, slot_pos, pos and the live slots' k and v
    read once (a masked slot need not be read), the fp32 output written
    once, over HBM bandwidth; or its 4·B·H·n_live·hd fp32 flops over the
    fp32 peak."""
    b, w, kk, hd = k.shape
    h = q.shape[1]
    nbytes = (q.numel() * q.element_size()
              + 2 * b * n_live * kk * hd * k.element_size()
              + 4 * w + 4 + 4 * out_elems)
    flops = 4 * b * h * n_live * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def decode_vs_plain(torch, ops, q, k, v, sp, pos, label, window=0):
    """Hold `decode_attention_fused` against its plain version and time
    kernel, plain version and `F.scaled_dot_product_attention` (q in the
    cache's dtype, enable_gqa, a boolean mask of the live slots) with
    `timings`.  Tolerance: |kernel − plain| ≤ 2e-5·|plain| + 2e-5·max|v| —
    the output is a convex combination of v's rows, and the two sum the
    softmax and the combine in another order.  A ring with no live slot
    must give the uniform average of v over the slots (finite)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    out = ops.decode_attention_fused(q, k, v, sp, pos, window=window)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k, v, sp, pos, window)
    vmax = float(v.abs().max())
    diff = (out - ref).abs()
    err = float(diff.max())
    ok = bool((diff <= 2e-5 * ref.abs() + 2e-5 * max(vmax, 1.0)).all()) \
        and bool(torch.isfinite(out).all())
    live = (sp >= 0) & (sp <= pos)
    if window > 0:
        live = live & (sp > pos - window)
    n_live = int(live.sum())
    if n_live == 0:
        uniform = v.float().mean(1).repeat_interleave(h // kk, dim=1)
        uni_err = float((out - uniform).abs().max())
        ok = ok and uni_err <= 2e-5 * max(vmax, 1.0)
        label += f" (|kernel - mean of v| {uni_err:.3g})"
    qs = q.to(k.dtype)[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = live[None, None, None, :]
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=h != kk)
    lib_err = float((lib[:, :, 0].float() - ref).abs().max())
    del out, ref, diff, lib
    t = timings(torch, lambda: ops.decode_attention_fused(q, k, v, sp, pos,
                                                          window=window),
                lambda: da.decode_attention_plain(q, k, v, sp, pos, window),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=h != kk))
    bound_ms, bound_by, nbytes = decode_bound_ms(q, k, n_live, b * h * hd)
    s, sps, tile = da.splits(q.device, b, kk, w, hd, h // kk,
                             k.dtype == torch.bfloat16)
    print(f"decode_attention {label} [B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
          f"q {q.dtype}, k/v {k.dtype}, {n_live} live slots, "
          f"{s} splits of {sps} in tiles of {tile}]: max_abs_err={err:g} "
          f"(max|v| {vmax:g}), |sdpa - plain| {lib_err:.3g}; "
          f"{timing_text(t, 'sdpa', bound_ms)}; bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e9:.3f} GB)")
    check(ok, f"decode_attention {label}: kernel and plain differ by {err:g}")
    return dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[b, h, w, kk, hd], dtype=str(k.dtype),
                q_dtype=str(q.dtype), splits=[s, sps, tile])


def path_e(torch, ops, dev, profile):
    """Dense serving at full qwen1.5-0.5b width (see the module docstring).
    Returns the launches, the step times, the peak memory and the kernel
    check's real inputs (layer 0's cache and a real query)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import build_lm
    from repro_torch.models.lm.layers import _project_qkv, apply_norm, embed
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_lm(get_config(LM_ARCH))
    cfg = lm.cfg
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    check(n == LM_PARAMS and cfg.n_layers == LM_LAYERS,
          f"{LM_ARCH} has {n} params, {cfg.n_layers} layers")
    check(all(t.dtype == torch.bfloat16 and t.device == dev
              for t in tree_leaves(params)), "serving params not bf16 on card")
    cache = lm.init_cache(SERVE_BATCH, SERVE_WINDOW)
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    check(tuple(cache["k"].shape) == (LM_LAYERS, SERVE_BATCH, SERVE_WINDOW,
                                      cfg.n_kv_heads, cfg.head_dim)
          and cache["k"].dtype == torch.bfloat16 and cache["k"].device == dev,
          f"cache {tuple(cache['k'].shape)} {cache['k'].dtype}")
    # a near-full 32k context, as decode_32k means: positions 0..F-1 hold
    # N(0, 1) k and v (a stand-in for a prefill's, as the weights are
    # random too), so the prompt and the decode steps fill the last slots
    fill = SERVE_WINDOW - SERVE_PROMPT - SERVE_STEPS
    g = torch.Generator(device=dev).manual_seed(1)
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[name][layer, :, :fill].normal_(generator=g)
    cache["slot_pos"][:, :fill] = torch.arange(fill, dtype=torch.int32,
                                               device=dev)
    cache["length"].fill_(fill)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to(dev)
    step = build_serve_step(lm)
    torch.cuda.synchronize()
    print(f"path e set-up in {time.perf_counter() - t0:.1f} s: {LM_ARCH} "
          f"full width ({n} bf16 params, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, hd "
          f"{cfg.head_dim}), cache batch {SERVE_BATCH} x {SERVE_WINDOW} slots "
          f"= {kv_bytes} B of bf16 k and v, positions 0..{fill - 1} "
          f"filled")
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens, logits, cache, secs = generate(step, params, cache, prompts,
                                           SERVE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = [1e3 * x for x in secs]
    tok_s = SERVE_BATCH * SERVE_STEPS / sum(secs)
    n_steps = SERVE_PROMPT + SERVE_STEPS
    print(f"path e (dense serving, decode_32k at batch {SERVE_BATCH}, "
          f"context {fill}..{SERVE_WINDOW - 1}): "
          f"{SERVE_PROMPT} prompt + {SERVE_STEPS} decode steps in "
          f"{wall:.3f} s; ms per decode step median "
          f"{statistics.median(ms):.3f} (min {min(ms):.3f}, max "
          f"{max(ms):.3f}; all {', '.join(f'{x:.3f}' for x in ms)}); "
          f"{tok_s:.1f} tokens per second; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}")
    print(f"path e first sequence's tokens: {tokens[0].tolist()}")
    check(launches["decode_attention_fused"] == LM_LAYERS * n_steps,
          f"decode_attention_fused launched "
          f"{launches['decode_attention_fused']} times, not "
          f"{LM_LAYERS} x {n_steps}")
    check(tuple(logits.shape) == (SERVE_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"path e logits {tuple(logits.shape)} not finite")
    check(tuple(tokens.shape) == (SERVE_BATCH, SERVE_STEPS + 1) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab)).all()), "path e tokens")
    check(int(cache["length"]) == SERVE_WINDOW,
          f"length {int(cache['length'])}")
    want_sp = torch.arange(SERVE_WINDOW, dtype=torch.int32, device=dev)
    check(bool((cache["slot_pos"] == want_sp).all()), "path e slot_pos")
    if profile:
        box = [cache, tokens[:, -1:]]

        def one_step():
            out, box[0] = step(params, box[0], box[1])
            box[1] = torch.argmax(out[:, -1:], dim=-1)

        by_name, _ = profile_round(torch, one_step, "path e decode step")
        print_families(by_name, "path e")
    # a real query for layer 0 at the last written position
    pos = cache["length"] - 1
    lp = tree_map(lambda t: t[0], params["layers"])
    with torch.inference_mode():
        x = apply_norm(cfg, embed(cfg, params["embed"], tokens[:, -2:-1]),
                       lp["ln1"])
        q, _, _ = _project_qkv(cfg, lp["attn"], x, pos.reshape(1))
    return dict(launches=launches, ms=ms, tok_s=tok_s, peak=peak,
                q=q[:, 0].clone(), k=cache["k"][0], v=cache["v"][0],
                sp=cache["slot_pos"][0], pos=pos.clone(),
                tokens=tokens[0].tolist())


def small_serve_agrees(torch, dev):
    """8 tokens of qwen1.5-0.5b and qwen3-32b (G = 8, hd 128) reduced, fp32,
    decoded on the card and on the CPU (the plain versions, which the CPU
    tests hold against the JAX reference): logits within 1e-4, equal
    greedy tokens; and the card's decode logits within 1e-4 of its own
    teacher-forced forward."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_map

    for arch, over in [("qwen1.5-0.5b", dict(n_kv_heads=4)),
                       ("qwen3-32b", dict(n_heads=16, n_kv_heads=2,
                                          head_dim=128))]:
        lm = build_lm(get_config(arch).reduced(**over))
        p0 = lm.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, lm.cfg.vocab, (3, 8)))
        step = build_serve_step(lm)
        runs = []
        for where in (dev, torch.device("cpu")):
            params = tree_map(lambda t: t.to(where), p0)
            cache = lm.init_cache(3, 8, device=where)
            got = []
            for t in range(8):
                out, cache = step(params, cache, tokens[:, t:t + 1].to(where))
                got.append(out[:, 0])
            runs.append((torch.stack(got, 1), params))
        (lc, pc), (lh, _) = runs
        with torch.no_grad():
            full, _ = lm.forward(pc, {"tokens": tokens.to(dev)})
        err = float((lc.cpu() - lh).abs().max())
        ferr = float((lc - full).abs().max())
        same = bool(torch.equal(lc.argmax(-1).cpu(), lh.argmax(-1)))
        print(f"small decode ({arch} reduced: {lm.cfg.n_layers} layers, "
              f"{lm.cfg.n_heads} heads / {lm.cfg.n_kv_heads} KV heads, hd "
              f"{lm.cfg.head_dim}, fp32; 3 x 8 tokens) card vs cpu max "
              f"|logit diff| {err:.3g}, greedy tokens equal {same}; card "
              f"decode vs card teacher-forced forward {ferr:.3g}")
        check(err <= 1e-4 and same, f"small decode {arch}: card and cpu "
                                    f"differ by {err}")
        check(ferr <= 1e-4, f"small decode {arch}: decode and forward differ "
                            f"by {ferr}")


# path n: the five LM families beside the dense one, at their registered
# widths (ROADMAP A.11.1); see the module docstring
N_RING, N_DEC_B, N_DEC_STEPS = 4096, 8, 16   # the timed decode ring
N_CHECK_B, N_CHECK_P = 2, 16                 # decode = forward at full width
# a train step's bf16 params and grads and fp32 momentum (8 B a param):
# the rest of 80 GB holds the update's fp32 temporary of the largest leaf
# (7.5 GB at llava's 32 layers), activations and the allocator's slack
N_TRAIN_BYTES = 48e9
N_ROUND_BYTES = 72e9    # a pod round's 20 B a param (path d's fused gossip)
N_ARCHS = {"n1": "llava-next-mistral-7b", "n2": "mixtral-8x7b",
           "n3": "arctic-480b", "n4": "mamba2-2.7b", "n5": "zamba2-2.7b",
           "n6": "whisper-large-v3", "n7": "mixtral-8x7b"}


def n_layers_within(cfg, per_param_bytes, budget, copies=1):
    """The most layers (at most the config's) whose `copies` models at
    `per_param_bytes` a param fit `budget` bytes."""
    import dataclasses

    best = 1
    for n in range(1, cfg.n_layers + 1):
        c = dataclasses.replace(cfg, n_layers=n)
        if copies * per_param_bytes * c.param_count() <= budget:
            best = n
    return best


def n_cut(cfg, layers, why):
    """cfg at `layers` layers, the cut printed."""
    import dataclasses

    if layers >= cfg.n_layers:
        return cfg
    print(f"  depth cut: {cfg.arch_id} {cfg.n_layers} -> {layers} layers "
          f"({why})")
    return dataclasses.replace(cfg, n_layers=layers)


def n_batch(torch, lm, b, s, dev, seed, **shapes):
    """A batch by `lm.input_specs(b, s)` (a name in `shapes` overrides its
    shape): int32 tokens and labels in [0, V), embeddings N(0, 1) · 0.05 in
    the activation dtype, drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, (shape, dtype) in lm.input_specs(b, s).items():
        shape = shapes.get(k, shape)
        if dtype == torch.int32:
            out[k] = torch.randint(0, lm.cfg.vocab, shape, generator=g,
                                   device=dev, dtype=torch.int32)
        else:
            out[k] = (torch.randn(shape, generator=g, device=dev) * 0.05
                      ).to(dtype)
    return out


def n_clock(torch, fn, reps):
    """fn() once to warm, then `reps` times, each ended by a synchronize:
    (the last result, ms of each timed call)."""
    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def n_add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def n_attn_layers(cfg):
    """decode_attention_fused launches per decode step."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def n_forward(torch, ops, lm, params, batch, tag, res, profile=False):
    """Forward (no grad, 1 warm + 2 timed) and the VT loss once; checks
    finite logits of [B, S_text, V], the loss's one VT launch, aux; with
    `profile`, one more forward under torch.profiler."""
    with torch.no_grad():
        (logits, aux), ms = n_clock(torch, lambda: lm.forward(params, batch),
                                    2)
        ops.reset_launches()
        t0 = time.perf_counter()
        total, met = lm.loss(params, batch)
        torch.cuda.synchronize()
        loss_ms = [1e3 * (time.perf_counter() - t0)]
        launches = dict(ops.LAUNCHES)
    b, s = batch["tokens"].shape
    check(tuple(logits.shape) == (b, s, lm.cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{tag}: logits {tuple(logits.shape)} not finite")
    check(launches["vt_kl_loss_fwd"] == 1,
          f"{tag}: the VT loss launched {launches} per loss")
    aux = float(aux)
    check(math.isfinite(float(total)) and (aux > 0) == (lm.cfg.family
                                                        == "moe"),
          f"{tag}: loss {float(total)}, aux {aux}")
    print(f"{tag} forward [B={b}, S={s}] ms {', '.join(f'{x:.2f}' for x in ms)}"
          f"; forward + VT loss {loss_ms[0]:.2f} ms, loss "
          f"{float(met['loss']):.5f}, aux {aux:.5f}, total "
          f"{float(total):.5f}")
    res.setdefault("fwd_ms", []).extend(ms)
    res["loss_ms"] = loss_ms[0]
    n_add(res.setdefault("launches", {}), launches)
    if profile:
        with torch.no_grad():
            by_name, _ = profile_round(
                torch, lambda: lm.forward(params, batch), f"{tag} forward")
        print_families(by_name, f"{tag} forward")
    return logits


def n_train(torch, ops, lm, params, batches, tag, res):
    """`build_train_step` on the given batches (the first warms), in
    place: finite losses, moved params, one VT forward and backward a
    step."""
    from repro_torch.dist.dfl_step import build_train_step
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves

    opt = sgd_momentum(lr=1e-3, momentum=0.9)
    state = opt.init(params)
    step = build_train_step(lm, opt, loss_kind="vt", beta=LM_BETA)
    probe = tree_leaves(params)[-1]
    before = probe.float().sum()
    ops.reset_launches()
    ms, losses = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, i, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = dict(ops.LAUNCHES)
    moved = bool(probe.float().sum() != before)
    print(f"{tag} train step ({lm.cfg.n_layers} layers, remat "
          f"{lm.cfg.remat}): ms {', '.join(f'{x:.1f}' for x in ms)} (the "
          f"first warms), losses {losses}, launches {launches}")
    check(all(math.isfinite(x) for x in losses) and moved,
          f"{tag}: train losses {losses}, params moved {moved}")
    check(launches["vt_kl_loss_fwd"] == launches["vt_kl_loss_bwd"]
          == len(batches), f"{tag}: train step launches {launches}")
    res["train_ms"] = ms
    n_add(res.setdefault("launches", {}), launches)
    del state


def n_decode_check(torch, lm, params, tokens, forward, tag, enc=None):
    """Decode `tokens` [B, P] one by one from an empty cache (the encoder's
    cross K / V filled first with `enc`) and hold the last position's
    logits against the teacher-forced forward's (`forward(lm)` -> logits
    [B, P, V]), twice over the same bf16 weights: with the registered bf16
    activations, the gap measured and the logits finite; and with fp32
    activations (the same widths), where the two paths compute the same
    numbers but for fp32 rounding, the gap held within 1e-3 of the
    largest |logit|.  In bf16 the two paths round in different places by
    design (the SSD forward rounds x·dt and each chunk's output to bf16,
    the recurrent step keeps them fp32; cuBLAS sums M = B and M = B·P rows
    in other orders), and the gap grows with depth: the reference's own
    bf16 gap exceeds tests/test_torch_serve.py's 2e-2 rule at 8 mamba2
    layers (tests/test_torch_families.py).  Returns {dtype: gap / largest
    |logit|}."""
    import dataclasses

    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm

    b, p = tokens.shape
    out_ratio = {}
    for dt in (lm.cfg.activation_dtype, "float32"):
        lmx = build_lm(dataclasses.replace(lm.cfg, activation_dtype=dt))
        with torch.no_grad():
            ref = forward(lmx)[:, -1].float()
        step = build_serve_step(lmx)
        with torch.inference_mode():
            cache = lmx.init_cache(b, 64, device=tokens.device)
            if enc is not None:
                cache = lmx.prep_decode_cache(params, cache, enc)
            for t in range(p):
                out, cache = step(params, cache, tokens[:, t:t + 1])
        got = out[:, 0].float()
        err = float((got - ref).abs().max())
        big = float(ref.abs().max())
        same = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        out_ratio[dt] = err / big
        print(f"{tag} decode vs teacher-forced forward, {dt} activations, "
              f"position {p - 1} [B={b}]: max |diff| {err:.4g}, largest "
              f"|logit| {big:.4g} (ratio {err / big:.4g}), argmax "
              f"agreement {same:.2f}")
        check(bool(torch.isfinite(got).all()) and math.isfinite(big),
              f"{tag}: {dt} decode logits not finite")
        del cache
    check(out_ratio["float32"] <= 1e-3,
          f"{tag}: fp32 decode and forward differ by "
          f"{out_ratio['float32']} of the largest logit")
    return out_ratio


def n_fill_ring(torch, cache, prefix, fill, dev, seed):
    """Fill a decode ring as path e fills its cache: N(0, 1) k and v at
    positions fill - W .. fill - 1 (those >= 0), each in slot p % W, and
    `length` = fill."""
    k, v, sp = (cache[prefix + n] for n in ("k", "v", "slot_pos"))
    w = k.shape[2]
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(max(fill - w, 0), fill, dtype=torch.int32,
                       device=dev)
    slots = (pos % w).long()
    for layer in range(k.shape[0]):
        k[layer][:, slots] = torch.randn((k.shape[1], len(pos)) + tuple(
            k.shape[3:]), generator=g, device=dev).to(k.dtype)
        v[layer][:, slots] = torch.randn((v.shape[1], len(pos)) + tuple(
            v.shape[3:]), generator=g, device=dev).to(v.dtype)
        sp[layer][slots] = pos
    cache["length"].fill_(fill)


def n_decode(torch, ops, lm, params, cache, tag, res, dev, fill=None,
             prefix="", steps=N_DEC_STEPS, profile=False):
    """1 + `steps` greedy steps of N_DEC_B sequences through
    `build_serve_step` on `cache` (its rings filled to `fill` first):
    decode_attention_fused must launch once per attention layer and step;
    ms per step, finite logits; with `profile`, one more step under
    torch.profiler.  Returns layer 0's ring (cloned) and the last
    position."""
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.launch.serve import generate

    cfg = lm.cfg
    if fill is not None:
        n_fill_ring(torch, cache, prefix, fill, dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (N_DEC_B, 1), generator=g,
                           device=dev)
    step = build_serve_step(lm)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens, logits, cache, secs = generate(step, params, cache, prompt,
                                           steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ms = [1e3 * x for x in secs]
    want = n_attn_layers(cfg) * (steps + 1)
    print(f"{tag} decode [B={N_DEC_B}] {steps + 1} steps in "
          f"{wall:.3f} s: ms per step median {statistics.median(ms):.3f} "
          f"(min {min(ms):.3f}, max {max(ms):.3f}), length "
          f"{int(cache['length'])}, launches {launches}")
    check(launches["decode_attention_fused"] == want,
          f"{tag}: decode_attention_fused launched "
          f"{launches['decode_attention_fused']} times, not {want}")
    check(tuple(logits.shape) == (N_DEC_B, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{tag}: decode logits not finite")
    res["dec_ms"] = ms
    n_add(res.setdefault("launches", {}), launches)
    if profile:
        box = [cache, tokens[:, -1:]]

        def one_step():
            out, box[0] = step(params, box[0], box[1])
            box[1] = torch.argmax(out[:, -1:], dim=-1)

        by_name, _ = profile_round(torch, one_step, f"{tag} decode step")
        print_families(by_name, f"{tag} decode step")
    if prefix + "k" not in cache:
        return None
    return dict(k=cache[prefix + "k"][0].clone(),
                v=cache[prefix + "v"][0].clone(),
                sp=cache[prefix + "slot_pos"][0].clone(),
                pos=(cache["length"] - 1).clone(),
                window=cfg.sliding_window or 0, h=cfg.n_heads)


def n_begin(torch, tag, arch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{tag} ({arch}):")
    return time.perf_counter(), {}


def n_end(torch, tag, t0, res):
    res["peak"] = torch.cuda.max_memory_allocated()
    res["s"] = time.perf_counter() - t0
    print(f"{tag} done in {res['s']:.1f} s, peak device memory "
          f"{res['peak'] / 2**30:.2f} GiB ({res['peak']} B)")


def n_build(torch, dev, cfg, seed=0):
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_leaves

    t0 = time.perf_counter()
    lm = build_lm(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    # `param_count` is analytic: it leaves out the SSM's conv bias and
    # dt_bias and the hybrid's 2D -> D in_proj (0.54% of zamba2), which
    # the layout has
    check(abs(n - cfg.param_count()) <= 5e-2 * n,
          f"{cfg.arch_id}: {n} params, the config counts "
          f"{cfg.param_count()}")
    dtypes = sorted({str(t.dtype) for t in tree_leaves(params)})
    check(all(t.device == dev for t in tree_leaves(params))
          and "torch.bfloat16" in dtypes, f"{cfg.arch_id}: params {dtypes} "
                                          f"off the card")
    print(f"  {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n} params (param_count() {cfg.param_count()}; "
          f"{n * 2 / 1e9:.2f} GB bf16; dtypes {dtypes}), drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    return lm, params


def n_slice_layers(params, key, layers):
    """The first `layers` layers of a stacked model (views)."""
    from repro_torch.utils.pytree import tree_map

    out = dict(params)
    out[key] = tree_map(lambda t: t[:layers], params[key])
    return out


def path_n(torch, ops, dev, profile=False):
    """The five families beside the dense one at their registered widths
    (n1-n7, see the module docstring).  Returns per sub-path results,
    the launches, the real logits for B.3 and the real rings for B.9.
    With `profile`, torch.profiler breakdowns of n1's, n4's and n6's
    forward and decode step."""
    import dataclasses

    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.models.lm.vlm import forward_text_only
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t_n = time.perf_counter()
    out = {"res": {}, "vt": {}, "rings": {}}
    gen = torch.Generator(device=dev).manual_seed(5)

    def check_tokens(cfg):
        return torch.randint(0, cfg.vocab, (N_CHECK_B, N_CHECK_P),
                             generator=gen, device=dev)

    # -- n1: llava-next-mistral-7b, all 32 layers -------------------------
    t0, res = n_begin(torch, "n1", N_ARCHS["n1"])
    cfg = get_config(N_ARCHS["n1"])
    lm, params = n_build(torch, dev, cfg)
    batch = n_batch(torch, lm, 1, cfg.img_tokens + 128, dev, 10)
    logits = n_forward(torch, ops, lm, params, batch, "n1", res, profile)
    out["vt"][cfg.vocab] = (logits.reshape(-1, cfg.vocab).contiguous(),
                            batch["labels"].reshape(-1).long())
    del logits
    toks = check_tokens(cfg)
    res["decode_gap"] = n_decode_check(
        torch, lm, params, toks,
        lambda lmx: forward_text_only(lmx.cfg, params, toks), "n1")
    cache = lm.init_cache(N_DEC_B, N_RING, device=dev)
    n_decode(torch, ops, lm, params, cache, "n1", res, dev,
             fill=N_RING - N_DEC_STEPS - 1, profile=profile)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    layers = n_layers_within(cfg, 8, N_TRAIN_BYTES)
    tcfg = n_cut(cfg, layers, f"a train step's params, grads and fp32 "
                              f"momentum within {N_TRAIN_BYTES / 1e9:.0f} GB")
    n_train(torch, ops, build_lm(tcfg), n_slice_layers(params, "layers",
                                                       layers),
            [n_batch(torch, lm, 1, cfg.img_tokens + 128, dev, 11 + i)
             for i in range(2)], "n1", res)
    del params, batch
    n_end(torch, "n1", t0, res)
    out["res"]["n1"] = res

    # -- n2: mixtral-8x7b, 8 of 32 layers ---------------------------------
    t0, res = n_begin(torch, "n2", N_ARCHS["n2"])
    cfg = n_cut(get_config(N_ARCHS["n2"]), 8, "the forward at 24 GB bf16; "
                "the train step below at 2")
    lm, params = n_build(torch, dev, cfg)
    batch = n_batch(torch, lm, 2, 512, dev, 20)
    logits = n_forward(torch, ops, lm, params, batch, "n2 global", res)
    lm_bl = build_lm(dataclasses.replace(cfg, moe_dispatch="batch_local"))
    logits_bl = n_forward(torch, ops, lm_bl, params, batch,
                          "n2 batch_local", res)
    gap = float((logits.float() - logits_bl.float()).abs().max())
    print(f"n2 global vs batch_local dispatch: max |logit diff| {gap:.4g} "
          f"(capacity per pool of {2 * 512} vs per row of 512 tokens)")
    del logits, logits_bl, lm_bl
    toks = check_tokens(cfg)
    # as the reference's decode = prefill oracle: a capacity that drops
    # nothing, so the B·P-token forward and the B-token steps route alike
    lm_nd = build_lm(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    res["decode_gap"] = n_decode_check(
        torch, lm_nd, params, toks,
        lambda lmx: lmx.forward(params, {"tokens": toks})[0], "n2")
    del lm_nd
    cache = lm.init_cache(N_DEC_B, 2 * N_RING, device=dev)
    check(cache["k"].shape[2] == cfg.sliding_window,
          f"n2 ring {tuple(cache['k'].shape)}")
    # a ring that has wrapped: positions 1,000 .. 5,079 before the steps
    n2_fill = cfg.sliding_window + 1000 - N_DEC_STEPS
    out["rings"]["mixtral window"] = n_decode(
        torch, ops, lm, params, cache, "n2", res, dev, fill=n2_fill)
    sp = cache["slot_pos"][0]
    want = n2_fill + N_DEC_STEPS + 1
    check(int(sp.max()) == want - 1 and int(sp.min()) == want
          - cfg.sliding_window, f"n2 ring positions {int(sp.min())}.."
                                f"{int(sp.max())}")
    del cache
    tcfg = n_cut(cfg, 2, "the train step")
    n_train(torch, ops, build_lm(tcfg), n_slice_layers(params, "layers", 2),
            [n_batch(torch, lm, 2, 512, dev, 21 + i) for i in range(2)],
            "n2", res)
    del params, batch
    n_end(torch, "n2", t0, res)
    out["res"]["n2"] = res

    # -- n3: arctic-480b, 1 of 35 layers ----------------------------------
    t0, res = n_begin(torch, "n3", N_ARCHS["n3"])
    cfg = n_cut(get_config(N_ARCHS["n3"]), 1, "13.6 B params a layer, 27 GB "
                "bf16; no train step: it needs >= 3x the params")
    lm, params = n_build(torch, dev, cfg)
    batch = n_batch(torch, lm, 1, 512, dev, 30)
    n_forward(torch, ops, lm, params, batch, "n3", res)
    toks = check_tokens(cfg)
    lm_nd = build_lm(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    res["decode_gap"] = n_decode_check(
        torch, lm_nd, params, toks,
        lambda lmx: lmx.forward(params, {"tokens": toks})[0], "n3")
    del lm_nd
    cache = lm.init_cache(N_DEC_B, N_RING, device=dev)
    out["rings"]["arctic G 7"] = n_decode(
        torch, ops, lm, params, cache, "n3", res, dev,
        fill=N_RING - N_DEC_STEPS - 1)
    del params, batch, cache
    n_end(torch, "n3", t0, res)
    out["res"]["n3"] = res

    # -- n4: mamba2-2.7b, all 64 layers -----------------------------------
    t0, res = n_begin(torch, "n4", N_ARCHS["n4"])
    cfg = get_config(N_ARCHS["n4"])
    lm, params = n_build(torch, dev, cfg)
    batch = n_batch(torch, lm, 2, 2048, dev, 40)
    logits = n_forward(torch, ops, lm, params, batch, "n4", res, profile)
    out["vt"][cfg.vocab] = (logits.reshape(-1, cfg.vocab).contiguous(),
                            batch["labels"].reshape(-1).long())
    del logits
    toks = check_tokens(cfg)
    res["decode_gap"] = n_decode_check(
        torch, lm, params, toks,
        lambda lmx: lmx.forward(params, {"tokens": toks})[0], "n4")
    sizes = {s: sum(t.numel() * t.element_size()
                    for t in lm.init_cache(N_DEC_B, s, device=dev).values())
             for s in (N_RING, 32 * N_RING)}
    print(f"n4 decode state bytes at seq_len {N_RING} / {32 * N_RING}: "
          f"{sizes[N_RING]} / {sizes[32 * N_RING]}")
    check(sizes[N_RING] == sizes[32 * N_RING], f"n4 cache sizes {sizes}")
    cache = lm.init_cache(N_DEC_B, N_RING, device=dev)
    n_decode(torch, ops, lm, params, cache, "n4", res, dev, steps=47)
    check(int(cache["length"]) == 48, f"n4 length {int(cache['length'])}")
    if profile:
        n_decode(torch, ops, lm, params, cache, "n4 (traced)", {}, dev,
                 steps=1, profile=True)
    del cache
    n_train(torch, ops, lm, params,
            [n_batch(torch, lm, 2, 2048, dev, 41 + i) for i in range(2)],
            "n4", res)
    del params, batch
    n_end(torch, "n4", t0, res)
    out["res"]["n4"] = res

    # -- n5: zamba2-2.7b, all 54 layers, B.9 at hd 80 ---------------------
    t0, res = n_begin(torch, "n5", N_ARCHS["n5"])
    cfg = get_config(N_ARCHS["n5"])
    check(cfg.head_dim == 80 and cfg.n_heads == cfg.n_kv_heads,
          f"zamba2 hd {cfg.head_dim}")
    lm, params = n_build(torch, dev, cfg)
    batch = n_batch(torch, lm, 2, 2048, dev, 50)
    n_forward(torch, ops, lm, params, batch, "n5", res)
    toks = check_tokens(cfg)
    res["decode_gap"] = n_decode_check(
        torch, lm, params, toks,
        lambda lmx: lmx.forward(params, {"tokens": toks})[0], "n5")
    cache = lm.init_cache(N_DEC_B, N_RING, device=dev)
    check(tuple(cache["attn_k"].shape) == (
        cfg.n_layers // cfg.shared_attn_every, N_DEC_B, N_RING,
        cfg.n_kv_heads, 80), f"n5 rings {tuple(cache['attn_k'].shape)}")
    out["rings"]["zamba2 hd 80"] = n_decode(
        torch, ops, lm, params, cache, "n5", res, dev,
        fill=N_RING - N_DEC_STEPS - 1, prefix="attn_")
    del cache
    n_train(torch, ops, lm, params,
            [n_batch(torch, lm, 2, 2048, dev, 51 + i) for i in range(2)],
            "n5", res)
    del params, batch
    n_end(torch, "n5", t0, res)
    out["res"]["n5"] = res

    # -- n6: whisper-large-v3, 32 + 32 layers -----------------------------
    t0, res = n_begin(torch, "n6", N_ARCHS["n6"])
    cfg = get_config(N_ARCHS["n6"])
    lm, params = n_build(torch, dev, cfg)
    frames, dec_len = 1500, 448   # 30 s of audio, the decoder's context
    batch = n_batch(torch, lm, 2, dec_len, dev, 60,
                    enc_embeds=(2, frames, cfg.d_model))
    logits = n_forward(torch, ops, lm, params, batch, "n6", res, profile)
    out["vt"][cfg.vocab] = (logits.reshape(-1, cfg.vocab).contiguous(),
                            batch["labels"].reshape(-1).long())
    del logits
    toks = check_tokens(cfg)
    enc = batch["enc_embeds"]
    res["decode_gap"] = n_decode_check(
        torch, lm, params, toks,
        lambda lmx: lmx.forward(params, {"tokens": toks,
                                         "enc_embeds": enc})[0], "n6",
        enc=enc)
    g = torch.Generator(device=dev).manual_seed(61)
    enc8 = (torch.randn((N_DEC_B, frames, cfg.d_model), generator=g,
                        device=dev) * 0.05).to(cfg.adtype)
    cache = lm.init_cache(N_DEC_B, dec_len, device=dev)
    with torch.inference_mode():
        cache, prep_ms = n_clock(
            torch, lambda: lm.prep_decode_cache(params, cache, enc8), 1)
    check(tuple(cache["cross_k"].shape) == (cfg.n_layers, N_DEC_B, frames,
                                            cfg.n_kv_heads, cfg.head_dim),
          f"n6 cross cache {tuple(cache['cross_k'].shape)}")
    print(f"n6 prep_decode_cache on {N_DEC_B} x {frames} frames: "
          f"{prep_ms[0]:.2f} ms (encoder + {cfg.n_layers} layers' cross "
          f"K / V)")
    res["prep_ms"] = prep_ms[0]
    out["rings"]["whisper hd 64"] = n_decode(
        torch, ops, lm, params, cache, "n6", res, dev,
        fill=dec_len - N_DEC_STEPS - 1)
    if profile:
        n_decode(torch, ops, lm, params, cache, "n6 (traced)", {}, dev,
                 steps=1, profile=True)
    del params, batch, cache, enc8
    n_end(torch, "n6", t0, res)
    out["res"]["n6"] = res

    # -- n7: the LM pod round with mixtral at 1 of 32 layers --------------
    t0, res = n_begin(torch, "n7", N_ARCHS["n7"])
    base = get_config(N_ARCHS["n7"])
    cfg = n_cut(base, n_layers_within(base, 20, N_ROUND_BYTES, copies=2),
                f"two nodes of the fused int8 round at 20 B a param "
                f"(bf16 params, fp32 momentum and the fp32 gossip block, "
                f"its average and its step) within "
                f"{N_ROUND_BYTES / 1e9:.0f} GB")
    lm = build_lm(cfg)
    params = init_nodes(lm, 2, dev)
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(2),
                                   loss_kind="vt", beta=LM_BETA,
                                   codec=Int8Codec(stochastic=False))
    (batch,) = list(make_batches(lm, 2, LM_BATCH, LM_SEQ, 1, dev))
    with torch.no_grad():
        node_aux = []
        for i in range(2):
            node = tree_map(lambda t, i=i: t[i], params)
            total, met = lm.loss(node, {k: v[i] for k, v in batch.items()})
            node_aux.append((float(total), float(met["loss"]),
                             float(met["aux"])))
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.perf_counter()
    params, state, loss = rnd(params, state, 0, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    launches = dict(ops.LAUNCHES)
    want = sum(t for t, _, _ in node_aux) / 2
    print(f"n7 pod round (2-node ring, fused int8, {cfg.n_layers} layer(s), "
          f"{cfg.param_count()} params a node): {ms:.1f} ms, loss "
          f"{float(loss):.5f} (the nodes' loss + 0.01 aux before the step: "
          f"{node_aux}), launches {launches}")
    check(math.isfinite(float(loss)) and abs(float(loss) - want)
          <= 1e-3 * abs(want), f"n7 loss {float(loss)} against {want}")
    check(all(abs(t - (m + cfg.router_aux_weight * a)) <= 1e-5 * abs(t)
              and a > 0 for t, m, a in node_aux), f"n7 aux {node_aux}")
    check(launches["dequant_neighbor_avg_rows"] == 1
          and launches["decdiff_update"] == 1
          and launches["vt_kl_loss_fwd"] == launches["vt_kl_loss_bwd"] == 2,
          f"n7 launches {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          "n7 params not finite")
    res["round_ms"] = ms
    res["launches"] = launches
    del params, state, rnd
    n_end(torch, "n7", t0, res)
    out["res"]["n7"] = res
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_n
    print(f"path n in all {out['s']:.1f} s")
    return out


N_FAMILY_ARCHS = ("llava-next-mistral-7b", "mixtral-8x7b", "arctic-480b",
                  "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3")


def n_reduced_agrees(torch, dev):
    """Each family's reduced preset (fp32) on the card and on the CPU (the
    plain versions, which tests/test_torch_families.py holds against the
    JAX package): forward logits within 1e-4, the VT loss and the router
    aux within 1e-5, and 8 decode tokens (logits within 1e-4, equal greedy
    tokens) from the same cache, mixtral's sliding window and the
    hybrid's rings small enough to wrap, whisper's cross K / V from
    `prep_decode_cache`."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_map

    cpu = torch.device("cpu")
    for arch in N_FAMILY_ARCHS:
        over = dict(sliding_window=4) if arch == "mixtral-8x7b" else {}
        lm = build_lm(get_config(arch).reduced(**over))
        cfg = lm.cfg
        p0 = lm.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        batch0 = {}
        for k, (shape, dtype) in lm.input_specs(2, 64).items():
            batch0[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab, shape).astype(np.int32)
                if dtype == torch.int32 else
                (rng.standard_normal(shape) * 0.05).astype(np.float32))
        enc0 = torch.from_numpy((rng.standard_normal(
            (2, 6, cfg.d_model)) * 0.05).astype(np.float32))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
        window = 5 if cfg.family == "hybrid" else 8
        runs = []
        for where in (dev, cpu):
            params = tree_map(lambda t: t.to(where), p0)
            batch = {k: v.to(where) for k, v in batch0.items()}
            with torch.no_grad():
                logits, aux = lm.forward(params, batch)
                total, met = lm.loss(params, batch)
            step = build_serve_step(lm)
            with torch.inference_mode():
                cache = lm.init_cache(2, window, device=where)
                if lm.prep_decode_cache is not None:
                    cache = lm.prep_decode_cache(params, cache,
                                                 enc0.to(where))
                dec = []
                for t in range(8):
                    out, cache = step(params, cache, toks[:, t:t + 1].to(
                        where))
                    dec.append(out[:, 0].cpu())
            runs.append((logits.cpu(), float(aux), float(met["loss"]),
                         torch.stack(dec, 1)))
        (lc, ac, sc, dc), (lh, ah, sh, dh) = runs
        errs = (float((lc - lh).abs().max()), abs(ac - ah), abs(sc - sh),
                float((dc - dh).abs().max()))
        same = bool(torch.equal(dc.argmax(-1), dh.argmax(-1)))
        print(f"small {cfg.family} ({arch} reduced, fp32) card vs cpu: "
              f"|logit| {errs[0]:.3g}, |aux| {errs[1]:.3g} (aux {ac:.6f}), "
              f"|VT loss| {errs[2]:.3g}, 8 decode steps |logit| "
              f"{errs[3]:.3g}, greedy tokens equal {same}")
        check(errs[0] <= 1e-4 and errs[1] <= 1e-5 and errs[2] <= 1e-5
              and errs[3] <= 1e-4 and same,
              f"small {arch}: card and cpu differ by {errs}")


def run_path_n(torch, ops, dev, card, profile=False):
    """Path n, the reduced presets card vs CPU, and B.9 / B.3 at path n's
    new shapes against their plain versions.  Returns (the launches of
    path n's runs, B.9's checks, B.3's checks by vocabulary)."""
    lmn = path_n(torch, ops, dev, profile)
    n_reduced_agrees(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    da_n = []
    for label, ring in lmn["rings"].items():
        b, _, kk, hd = ring["k"].shape
        q = torch.randn((b, ring["h"], hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        da_n.append(dict(decode_vs_plain(
            torch, ops, q, ring["k"], ring["v"], ring["sp"], ring["pos"],
            f"path n {label} (real ring)", ring["window"]), label=label))
        del q
    lmn["rings"].clear()
    torch.cuda.empty_cache()
    vt_n = {}
    for v, (z, y) in sorted(lmn["vt"].items()):
        vt_n[v] = vt_vs_plain(torch, ops, z, y,
                              f"path n real logits, V = {v}"
                              + (" (not a multiple of 8: narrower vectors)"
                                 if v % 8 else ""))
    lmn["vt"].clear()
    torch.cuda.empty_cache()
    launches = {}
    for res in lmn["res"].values():
        n_add(launches, res["launches"])
    print(f"path n ({card}): " + "; ".join(
        f"{k} {N_ARCHS[k]} {r['s']:.1f} s, peak {r['peak'] / 2**30:.2f} GiB"
        + (f", forward ms {statistics.median(r['fwd_ms']):.2f}"
           if "fwd_ms" in r else "")
        + (f", train step ms {r['train_ms'][-1]:.1f}"
           if "train_ms" in r else "")
        + (f", decode step ms {statistics.median(r['dec_ms']):.3f}"
           if "dec_ms" in r else "")
        + (f", pod round ms {r['round_ms']:.1f}" if "round_ms" in r else "")
        for k, r in lmn["res"].items()) + f"; path n in all {lmn['s']:.1f} s")
    return launches, da_n, vt_n


# ----------------------------------------------------------------- path o
# checkpoints (ROADMAP A.11.2) and the dry run (A.11.4) at full width

O_DIR = ROOT / "build" / "path_o"     # path o's checkpoint and dry run
O_NODES, O_STEPS, O_BATCH, O_SEQ = 2, 3, 4, 128
O_PROMPT, O_NEW = 8, 8                # o3: prompt and decoded tokens
O_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def o_digests(torch, tree):
    """{path: sha256 of the leaf's bytes} over a state tree's leaves."""
    import hashlib

    from repro_torch.checkpoint.ckpt import _flatten_with_paths

    out = {}
    for key, t in _flatten_with_paths(tree):
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[key] = hashlib.sha256(memoryview(t.cpu().numpy()).cast("B")
                                  ).hexdigest()
    return out


def o_npz_descrs(path):
    """{member: its npy header's descr} of an npz archive."""
    import ast
    import struct
    import zipfile

    import numpy as np

    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                fmt, size = ("<H", 2) if version == (1, 0) else ("<I", 4)
                n = struct.unpack(fmt, f.read(size))[0]
                header = ast.literal_eval(f.read(n).decode("latin1"))
                out[name[:-len(".npy")]] = header["descr"]
    return out


def o_dryrun_start():
    """The dry run for qwen1.5-0.5b at its four shapes on both meshes, one
    process per shape and mesh, started now (in a fresh `O_DIR`) and read
    by `o_dryrun_finish`: they run on the host's cores beside paths n and
    o, at the lowest priority (nice 19, so the paths they run beside keep
    their cores), and place nothing on the card."""
    import os
    import shutil

    if O_DIR.exists():
        shutil.rmtree(O_DIR)
    O_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    for shape in O_SHAPES:
        for mesh in ("single", "multi"):
            log = open(O_DIR / f"dryrun_{shape}_{mesh}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 LM_ARCH, "--shape", shape, "--mesh", mesh, "--out",
                 str(O_DIR / "dryrun"), "--force"],
                cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
            os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
            procs[(shape, mesh)] = (proc, log, time.perf_counter())
    return procs


def o_dryrun_stop(procs):
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def o_dryrun_finish(procs, card):
    out = {}
    try:
        for (shape, mesh), (proc, log, t0) in procs.items():
            rc = proc.wait(timeout=600)
            out[f"{shape} {mesh}"] = time.perf_counter() - t0
            text = (O_DIR / f"dryrun_{shape}_{mesh}.log").read_text()
            print(f"path o4 dry run, {shape} {mesh} (exit {rc}, process "
                  f"ended {out[f'{shape} {mesh}']:.1f} s after its start): "
                  + "; ".join(text.strip().splitlines()))
            check(rc == 0, f"path o4: the {shape} {mesh} dry run exited "
                           f"{rc}:\n{text}")
    finally:
        o_dryrun_stop(procs)
    recs = {}
    for shape in O_SHAPES:
        for mesh in ("single", "multi"):
            path = O_DIR / "dryrun" / f"{LM_ARCH}__{shape}__{mesh}.json"
            rec = json.loads(path.read_text())
            check(rec["ok"], f"path o4: {shape} {mesh}: {rec.get('error')}")
            mem = rec["memory_analysis"]
            recs[(shape, mesh)] = rec
            print(f"path o4 {shape:12s} {mesh:6s} ({card}): FLOPs per chip "
                  f"{rec['cost_analysis']['flops']:.6e}, bytes accessed per "
                  f"chip {rec['cost_analysis']['bytes accessed']:.6e}, "
                  f"argument bytes per device "
                  f"{mem['argument_size_in_bytes']}, temp bytes per device "
                  f"{mem['temp_size_in_bytes']} ("
                  f"{'upper bound, ' if mem['temp_is_upper_bound'] else ''}"
                  f"batch {mem['temp_batch_per_device']} a device), output "
                  f"{mem['output_size_in_bytes']}, fits_hbm "
                  f"{rec['fits_hbm']} ({rec['hbm_bytes']:.0f} B), "
                  f"collectives {rec['collectives']['total']:.0f} B, "
                  f"useful FLOPs ratio {rec.get('useful_flops_ratio')}, "
                  f"trace {rec['trace_s']:.1f} s")
    return recs, out


def path_o(torch, ops, dev, card, procs=None):
    """Path o: checkpoints and the dry run (see the module docstring; the
    dry run's processes `procs` from `o_dryrun_start`, or started here).
    Returns the launches of its main-path runs by sub-path, its timings
    and the dry run's records."""
    import shutil

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round, build_serve_step
    from repro_torch.launch import train
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t_path = time.perf_counter()
    procs = procs or o_dryrun_start()
    res = {"launches": {}}
    try:
        # bf16 params and fp32 momentum of every node, and a margin
        need = O_NODES * LM_PARAMS * (2 + 4)
        free = shutil.disk_usage(O_DIR).free
        print(f"path o: the checkpoint needs {need} B, {free} B free under "
              f"{O_DIR}")
        check(free > 1.5 * need, f"path o: {free} B free on the disk under "
                                 f"{O_DIR}, the checkpoint needs {need} B")
        ckpt_dir = O_DIR / "ckpt"

        # -- o1: launch/train.py at full width with --ckpt-dir -----------------
        timed = {}

        def timed_save(*args, **kwargs):
            t0 = time.perf_counter()
            path = save_checkpoint(*args, **kwargs)
            timed["write_s"] = time.perf_counter() - t0
            return path

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        save, train.save_checkpoint = train.save_checkpoint, timed_save
        try:
            ops.reset_launches()
            t0 = time.perf_counter()
            losses, params, opt_state = train.run(
                ["--arch", LM_ARCH, "--preset", "full", "--nodes",
                 str(O_NODES), "--steps", str(O_STEPS), "--batch",
                 str(O_BATCH), "--seq", str(O_SEQ), "--ckpt-dir",
                 str(ckpt_dir), "--log-every", "1"])
            torch.cuda.synchronize()
            res["launches"]["o1"] = dict(ops.LAUNCHES)
            res["o1_s"] = time.perf_counter() - t0
        finally:
            train.save_checkpoint = save
        l1 = res["launches"]["o1"]
        check(l1["vt_kl_loss_fwd"] == l1["vt_kl_loss_bwd"]
              == O_NODES * O_STEPS and l1["decdiff_update"] == O_STEPS,
              f"path o1: launches {l1}")
        check(all(math.isfinite(x) for x in losses), f"path o1: {losses}")
        state = {"params": params, "opt": opt_state}
        leaves = tree_leaves(params)
        check(sum(t[0].numel() for t in leaves) == LM_PARAMS
              and all(t.dtype == torch.bfloat16 for t in leaves)
              and all(t.dtype == torch.float32
                      for t in tree_leaves(opt_state)),
              "path o1: the state is not bf16 params and fp32 momentum")
        step_dir = ckpt_dir / f"step_{O_STEPS:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        from repro_torch.checkpoint.ckpt import _flatten_with_paths

        want = {k: {"shape": list(t.shape),
                    "dtype": {torch.bfloat16: "bfloat16",
                              torch.float32: "float32"}[t.dtype]}
                for k, t in _flatten_with_paths(state)}
        check(manifest["keys"] == want and manifest["step"] == O_STEPS
              and manifest["metadata"] == {"arch": LM_ARCH, "mode": "dfl"},
              "path o1: the manifest's keys, shapes, dtypes or metadata")
        descrs = o_npz_descrs(step_dir / "arrays.npz")
        check(list(descrs) == list(want) and all(
            descrs[k] == ("<V2" if v["dtype"] == "bfloat16" else "<f4")
            for k, v in want.items()),
            f"path o1: npy headers {sorted(set(descrs.values()))}")
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        res.update(ckpt_bytes=ckpt_bytes, write_s=timed["write_s"],
                   o1_peak=torch.cuda.max_memory_allocated(), losses=losses)
        print(f"path o1 ({card}): {LM_ARCH} full width, {O_NODES} nodes x "
              f"{LM_PARAMS} bf16 params, {O_STEPS} DFL rounds of batch "
              f"{O_BATCH} x seq {O_SEQ} in {res['o1_s']:.1f} s (losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}), peak "
              f"{res['o1_peak'] / 2**30:.2f} GiB; checkpoint "
              f"{ckpt_bytes / 1e9:.3f} GB ({len(want)} leaves) written in "
              f"{timed['write_s']:.2f} s; launches {l1}")

        # -- o2: restore onto the card, bitwise, and one more round ----------
        t0 = time.perf_counter()
        restored, man2 = restore_checkpoint(str(ckpt_dir), device=dev)
        torch.cuda.synchronize()
        res["read_s"] = time.perf_counter() - t0
        check(man2 == manifest, "path o2: the restored manifest differs")
        t0 = time.perf_counter()
        d_mem, d_rest = o_digests(torch, state), o_digests(torch, restored)
        digest_s = time.perf_counter() - t0
        check(d_mem == d_rest and list(d_rest) == list(want),
              "path o2: a restored leaf is not bitwise the state o1 ended "
              "with")
        check(all(t.device == dev for t in tree_leaves(restored["params"])),
              "path o2: the restored leaves are not on the card")
        print(f"path o2 ({card}): checkpoint {ckpt_bytes / 1e9:.3f} GB read "
              f"onto the card in {res['read_s']:.2f} s; {len(d_rest)} "
              f"leaves bitwise the state o1 ended with (sha256, "
              f"{digest_s:.1f} s for both)")
        # node 0's params as checkpointed, for o3
        node0 = {"rest": tree_map(lambda t: t[0].clone(), restored["params"]),
                 "mem": tree_map(lambda t: t[0].clone(), params)}
        lm = build_lm(get_config(LM_ARCH))
        opt = sgd_momentum(lr=3e-3, momentum=0.9)
        rnd = build_dfl_round(lm, opt, train.ring_adjacency(O_NODES),
                              loss_kind="vt", beta=LM_BETA)
        batch = next(iter(train.make_batches(lm, O_NODES, O_BATCH, O_SEQ, 1,
                                             dev, seed=O_STEPS * 131)))
        ops.reset_launches()
        p_r, _, loss_r = rnd(restored["params"], restored["opt"], O_STEPS,
                             batch)
        torch.cuda.synchronize()
        res["launches"]["o2"] = dict(ops.LAUNCHES)
        p_m, _, loss_m = rnd(params, opt_state, O_STEPS, batch)
        torch.cuda.synchronize()
        l2 = res["launches"]["o2"]
        check(l2["vt_kl_loss_fwd"] == l2["vt_kl_loss_bwd"] == O_NODES
              and l2["decdiff_update"] == 1, f"path o2: launches {l2}")
        same_round = (float(loss_r) == float(loss_m)
                      and o_digests(torch, p_r) == o_digests(torch, p_m))
        print(f"path o2: one more round from the restored state, loss "
              f"{float(loss_r):.6f}, bitwise the in-memory state's "
              f"({float(loss_m):.6f}): {same_round}; launches {l2}")
        check(same_round, "path o2: the round from the restored state "
                          "differs from the in-memory state's")
        del restored, p_r, p_m, params, opt_state, state
        gc.collect()
        torch.cuda.empty_cache()

        # -- o3: decode from node 0's restored params ------------------------
        gen = torch.Generator(device=dev).manual_seed(7)
        prompts = torch.randint(0, lm.cfg.vocab, (O_BATCH, O_PROMPT),
                                generator=gen, device=dev)
        step = build_serve_step(lm)
        out = {}
        for key in ("rest", "mem"):
            cache = lm.init_cache(O_BATCH, O_PROMPT + O_NEW, device=dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            toks, logits, _, _ = generate(step, node0[key], cache, prompts,
                                          O_NEW - 1)
            torch.cuda.synchronize()
            out[key] = (toks, logits, time.perf_counter() - t0,
                        dict(ops.LAUNCHES))
            del cache
        res["launches"]["o3"] = out["rest"][3]
        l3 = out["rest"][3]
        n_steps = O_PROMPT + O_NEW - 1
        check(l3["decode_attention_fused"] == LM_LAYERS * n_steps,
              f"path o3: decode_attention_fused launched "
              f"{l3['decode_attention_fused']} times, not {LM_LAYERS} x "
              f"{n_steps}")
        same_decode = (torch.equal(out["rest"][0], out["mem"][0])
                       and torch.equal(out["rest"][1], out["mem"][1]))
        check(tuple(out["rest"][0].shape) == (O_BATCH, O_NEW)
              and bool(torch.isfinite(out["rest"][1].float()).all()),
              "path o3: tokens or logits")
        print(f"path o3 ({card}): {O_NEW} tokens of {O_BATCH} sequences "
              f"from node 0's restored params in {out['rest'][2]:.2f} s, "
              f"tokens and logits bitwise the in-memory params': "
              f"{same_decode}; first sequence "
              f"{out['rest'][0][0].tolist()}; launches {l3}")
        check(same_decode, "path o3: the decode from the restored params "
                           "differs")
        del node0, out
        torch.cuda.empty_cache()
    except BaseException:
        o_dryrun_stop(procs)
        raise

    # -- o4: the dry run --------------------------------------------------
    res["dryrun"], res["dryrun_s"] = o_dryrun_finish(procs, card)
    shutil.rmtree(O_DIR / "ckpt")
    res["s"] = time.perf_counter() - t_path
    print(f"path o ({card}): checkpoint {res['ckpt_bytes'] / 1e9:.3f} GB, "
          f"write {res['write_s']:.2f} s, read {res['read_s']:.2f} s; "
          f"path o in all {res['s']:.1f} s")
    return res


# ----------------------------------------------------------------- path p
# the examples (ROADMAP A.12.1): each `examples_torch/*.py` main at the
# reference example's defaults, on the card

P_DIR = ROOT / "build" / "path_p"     # path p's rendezvous and results
P_EXAMPLES = ROOT / "examples_torch"
P_PODS = 2                            # the multi-pod example's gloo ranks
P_KERNELS = ("segment_neighbor_avg", "decdiff_update", "drift_norms",
             "vt_kl_loss_fwd", "vt_kl_loss_bwd", "gather_rows",
             "neighbor_avg", "decode_attention_fused")
# a verbose round line; the loss may be nan: an isolated node can diverge
# at the examples' lr 0.1 (quickstart's isol)
P_ROUND = (r"\[{m}\] round +\d+  acc \d\.\d{{4}} ± \d\.\d{{4}}  loss "
           r"(\d+\.\d{{4}}|nan|inf)")


def p_example(name):
    """`examples_torch/<name>.py` as a module (the examples are scripts,
    not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", P_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tee:
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def p_main(torch, ops, mod, argv, label):
    """`mod.main(argv)` with every launch count set to 0 just before and
    read just after, its printed lines kept: (its return, the lines, the
    launches, wall seconds)."""
    import contextlib

    torch.cuda.synchronize()
    ops.reset_launches()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"path p {label}: {wall:.2f} s; launches "
          f"{ {k: launches[k] for k in P_KERNELS} }")
    return out, tee.text().splitlines(), launches, wall


def p_expected(ops, runs, steps=4):
    """The launches of `runs` [(method, rounds, comm)] on the dense
    layout: the segment reduce (B.1) once a round on the gossip methods,
    Eq. 5 (B.2) once a round on decdiff*, the drift norms (B.2's pass A)
    once a round with a transport, the VT loss (B.3) forward and backward
    once a local step on +vt, `gather_rows` (B.4) once a round on the
    per-edge transport, `neighbor_avg` (B.6) once a round on fedavg."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for method, rounds, comm in runs:
        if method in ("dechetero", "cfa", "cfa-ge", "decdiff", "decdiff+vt"):
            want["segment_neighbor_avg"] += rounds
        if method.startswith("decdiff"):
            want["decdiff_update"] += rounds
        if method.endswith("+vt"):
            want["vt_kl_loss_fwd"] += rounds * steps
            want["vt_kl_loss_bwd"] += rounds * steps
        if method == "fedavg":
            want["neighbor_avg"] += rounds
        if comm is not None:
            want["drift_norms"] += rounds
            if comm.use_per_edge:
                want["gather_rows"] += rounds
    return want


def p_lines(lines, patterns, label):
    """Every pattern matches a printed line, in order (other lines may
    come between)."""
    i = 0
    for pat in patterns:
        while i < len(lines) and not re.fullmatch(pat, lines[i]):
            i += 1
        check(i < len(lines), f"path p {label}: no line matching {pat!r} "
                              f"in order; printed {lines}")
        i += 1


def p_agree(torch, label, a, b, n_test, grain=0.0, atol=1e-6):
    """Two runs of one spec, the card's and the CPU's, each (experiment,
    history): params within `atol` + `grain`, every eval's accuracies
    within one test sample, bytes and triggers exact."""
    from repro_torch.utils.pytree import tree_leaves

    (ea, ha), (eb, hb) = a, b
    gap = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
              zip(tree_leaves(ea.params), tree_leaves(eb.params)))
    acc = max(float(abs(x.acc_per_node - y.acc_per_node).max()) * n_test
              for x, y in zip(ha, hb))
    same = ([m.round for m in ha] == [m.round for m in hb]
            and [m.bytes_on_wire for m in ha] == [m.bytes_on_wire for m in hb]
            and ea.comm_bytes_total == eb.comm_bytes_total
            and ea.trig_history == eb.trig_history)
    print(f"path p card vs cpu, {label}: params gap {gap:.3g} (bound "
          f"{atol + grain:.3g}), accuracy gap {acc:.3g} test samples, bytes "
          f"{ea.comm_bytes_total:.0f} / {eb.comm_bytes_total:.0f}, triggered "
          f"equal {ea.trig_history == eb.trig_history}")
    check(gap <= atol + grain, f"path p {label}: card and cpu params differ "
                               f"by {gap}")
    check(acc <= 1.0 + 1e-6, f"path p {label}: accuracies differ by {acc} "
                             f"test samples")
    check(same, f"path p {label}: rounds, bytes or triggers differ")


def p_card_vs_cpu(torch, dev, qs, cg, dm):
    """quickstart's two methods, compressed_gossip's six transports (int8
    deterministic) and two of decentralized_mnist's methods, 3 rounds each
    at a reduced size, on the card and on the CPU from the same init (the
    port draws every init on the CPU)."""
    from repro_torch.utils.pytree import tree_leaves

    cpu = torch.device("cpu")
    worlds = {w: qs.build_world(8, w)[0] for w in (dev, cpu)}
    n_test = len(worlds[cpu].y_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    for method in qs.METHODS:
        runs = []
        for w in (dev, cpu):
            exp = qs.experiment(worlds[w], method, 3, 1)
            runs.append((exp, exp.run()))
        p_agree(torch, f"quickstart {method} (8 nodes)", *runs, used)
    world = cg.smoke_world()
    n_test = len(world[0].y_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    for comm in cg.default_sweep(stochastic=False):
        runs = [cg.run_one(world, comm, 3, device=w) for w in (dev, cpu)]
        top = max(float(t.abs().max()) for t in tree_leaves(runs[1][0].params))
        grain = {"fp32": 0.0, "int8": top / 127.0, "bf16": top * 2.0 ** -7,
                 "topk": top}[comm.codec]
        trig = cg.trigger_label(comm.policy, comm.trigger_threshold,
                                comm.target_trigger)
        p_agree(torch, f"compressed_gossip {comm.codec} {trig}", *runs, used,
                grain=grain, atol=1e-4)
    wc = dm.WorldConfig(num_nodes=8, data_scale=0.02, rounds=3, eval_every=1)
    world = dm.build_world(wc)
    n_test = len(world[0].y_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    for method in ("decdiff+vt", "fedavg"):
        ra, rb = (dm.run_method(wc, method, world=world, device=w)
                  for w in (dev, cpu))
        acc = max(abs(x - y) for x, y in zip(ra["acc_per_node"],
                                             rb["acc_per_node"])) * used
        mean = max(abs(x["acc_mean"] - y["acc_mean"])
                   for x, y in zip(ra["history"], rb["history"])) * used
        print(f"path p card vs cpu, decentralized_mnist run_method {method} "
              f"(8 nodes): final accuracy gap {acc:.3g} test samples, mean "
              f"accuracy gap {mean:.3g} over {len(ra['history'])} evals, "
              f"bytes per round {ra['comm_bytes_per_round']} / "
              f"{rb['comm_bytes_per_round']}")
        check(acc <= 1.0 + 1e-6 and mean <= 1.0 + 1e-6,
              f"path p decentralized_mnist {method}: accuracies differ")
        check(ra["comm_bytes_per_round"] == rb["comm_bytes_per_round"]
              and sorted(ra) == sorted(rb),
              f"path p decentralized_mnist {method}: bytes or keys differ")


def p_digest(out):
    """What the one- and two-rank multi-pod runs are held to, bitwise and
    picklable."""
    from repro_torch.utils.pytree import tree_leaves

    return dict(params=[t.cpu().numpy() for t in tree_leaves(out["params"])],
                acc=[m.acc_per_node.tolist() for m in out["history"]],
                dist=(out["init_dist"], out["final_dist"]),
                n_pods=out["n_pods"])


def p_worker(rank, n_pods, out_dir):
    """One gloo rank of the multi-pod example on the one card (cuda:0):
    `main([])` on the group this worker starts; results pickled to
    `out_dir/rank<r>.pkl`."""
    import contextlib
    import io
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    mod = p_example("multipod_dfl_train")
    store = dist.FileStore(str(Path(out_dir) / "store"), n_pods)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=n_pods)
    try:
        buf = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main([])
        torch.cuda.synchronize()
        res = dict(digest=p_digest(out), lines=buf.getvalue().splitlines(),
                   s=time.perf_counter() - t0, launches=dict(ops.LAUNCHES))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def p_same(a, b):
    """Params, accuracies and distances bitwise (the pod counts differ)."""
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                    b["params"])) \
        and a["acc"] == b["acc"] and a["dist"] == b["dist"]


def path_p(torch, ops, dev, card):
    """The five examples at the reference's defaults (module docstring);
    returns what the summary and the kernels line read."""
    import pickle
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    t_path = time.perf_counter()
    qs, cg, dm, mp_ex, sd = (p_example(n) for n in (
        "quickstart", "compressed_gossip", "decentralized_mnist",
        "multipod_dfl_train", "serve_decode"))
    res = {"s": {}, "ms": {}, "launches": {}}

    # -- p1: quickstart, 16 nodes, 30 rounds, isol and decdiff+vt --------
    hists, lines, l1, s = p_main(torch, ops, qs, [], "quickstart")
    res["s"]["quickstart"], res["launches"]["quickstart"] = s, l1
    res["ms"]["quickstart"] = 1e3 * s / 60
    p_lines(lines, [r"graph: erdos_renyi\(n=16,p=0\.25\)  \(connected="
                    r"(True|False)\)  label-skew Gini=\d\.\d\d"]
            + [p for m in qs.METHODS for p in
               [P_ROUND.format(m=re.escape(m))] * 4
               + [rf"--> {re.escape(m)}: final node-average accuracy "
                  rf"\d\.\d{{3}} ± \d\.\d{{3}}"]], "quickstart")
    check(sorted(hists) == sorted(qs.METHODS)
          and all([h.round for h in hist] == [0, 10, 20, 29]
                  for hist in hists.values()),
          f"path p quickstart: histories {hists}")
    want = p_expected(ops, [(m, 30, None) for m in qs.METHODS])
    check(l1 == want, f"path p quickstart: launches {l1}, want {want}")
    for m, hist in hists.items():
        check(all(math.isfinite(h.acc_mean) and 0 <= h.acc_mean <= 1
                  for h in hist), f"path p quickstart {m}: accuracies")

    # -- p2: compressed_gossip, the six transports, 15 rounds each -------
    rows, lines, l2, s = p_main(torch, ops, cg, [], "compressed_gossip")
    res["s"]["compressed_gossip"], res["launches"]["compressed_gossip"] = \
        s, l2
    res["ms"]["compressed_gossip"] = 1e3 * s / (6 * 15)
    header = (f"{'codec':>6} {'trigger':>14} | {'final acc':>9} | "
              f"{'wire MB':>8} | {'trig':>5} | reduction")
    p_lines(lines, [re.escape(header)]
            + [rf" *{r['comm'].codec} +{re.escape(r['trigger'])} \| "
               rf"+\d\.\d{{4}} \| +\d+\.\d\d \| +\d\.\d\d \| \d+\.\dx"
               for r in rows], "compressed_gossip")
    want = p_expected(ops, [("decdiff+vt", 15, r["comm"]) for r in rows])
    check(l2 == want, f"path p compressed_gossip: launches {l2}, want {want}")
    by = {(r["comm"].codec, r["comm"].policy, r["comm"].trigger_threshold):
          r for r in rows}
    for key in (("fp32", "fixed", 0.0), ("bf16", "fixed", 0.0),
                ("int8", "fixed", 0.0), ("topk", "fixed", 0.0)):
        r = by[key]
        want_b = r["payload_bytes"] * r["directed_edges"] * 15
        print(f"path p compressed_gossip {key[0]}: bytes {r['bytes']:.0f} = "
              f"{r['payload_bytes']} x {r['directed_edges']} x 15: "
              f"{r['bytes'] == want_b}")
        check(r["bytes"] == want_b, f"path p compressed_gossip {key}: bytes "
                                    f"{r['bytes']} != {want_b}")
    ratio = by[("fp32", "fixed", 0.0)]["payload_bytes"] \
        / by[("int8", "fixed", 0.0)]["payload_bytes"]
    check(by[("int8", "fixed", 0.0)]["reduction"] == f"{ratio:.1f}x",
          f"path p compressed_gossip: int8 reduction "
          f"{by[('int8', 'fixed', 0.0)]['reduction']} against the payload "
          f"ratio {ratio}")
    for r in rows:
        h = r["history"][-1]
        check(0 <= h.acc_mean <= 1 and 0 < h.triggered_frac <= 1,
              f"path p compressed_gossip {r['comm']}: acc {h.acc_mean}, "
              f"triggered {h.triggered_frac}")

    # -- p3: decentralized_mnist, 20 nodes, 60 rounds, Tables II / IV ----
    (tables, ct), lines, l3, s = p_main(torch, ops, dm, [],
                                        "decentralized_mnist")
    res["s"]["decentralized_mnist"] = s
    res["launches"]["decentralized_mnist"] = l3
    results = tables["synth-mnist"]
    res["ms"]["decentralized_mnist"] = {
        m: 1e3 * results[m]["wall_s"] / 60 for m in dm.METHODS}
    res["ms"]["centralized_s"] = results["centralized"]["wall_s"]
    p_lines(lines, [r"\[synth-mnist\] centralized acc=\d\.\d{4}"]
            + [rf"\[synth-mnist\] {re.escape(f'{m:12s}')} acc=\d\.\d{{4}} "
               rf"±\d\.\d{{4}}  \(\d+s\)" for m in dm.METHODS]
            + [r"=== Table II \(accuracy\) ===",
               re.escape("| dataset | method | avg acc | ±std | "
                         "node-wise IQR |"),
               re.escape("|---|---|---|---|---|")]
            + [rf"\| synth-mnist \| {re.escape(m)} \| \d\.\d{{4}} \| "
               rf"\d\.\d{{4}} \| (\d\.\d{{3}})? \|"
               for m in ["centralized"] + dm.METHODS]
            + [r"=== Table IV \(characteristic time\) ===",
               re.escape("| dataset | method | 50% | 80% | 90% | 95% |")]
            + [rf"\| synth-mnist \| {re.escape(m)} \| "
               rf"((\d+|-) \| ){{3}}(\d+|-) \|" for m in dm.METHODS],
            "decentralized_mnist")
    want = p_expected(ops, [(m, 60, None) for m in dm.METHODS])
    check(l3 == want, f"path p decentralized_mnist: launches {l3}, want "
                      f"{want}")
    rows2 = [(m, r) for m, r in results.items() if not m.startswith("_")]
    check(len(rows2) == 8 and all(
        math.isfinite(r["acc_mean"]) and 0 <= r["acc_mean"] <= 1
        and math.isfinite(r["acc_std"]) for _, r in rows2),
        f"path p decentralized_mnist: Table II rows {rows2}")
    cacc = results["centralized"]["acc_mean"]
    for m in dm.METHODS:
        for thr, hit in ct["synth-mnist"]["times"][m].items():
            first = next((h["round"] for h in results[m]["history"]
                          if h["acc_mean"] >= thr * cacc), None)
            check(hit == first, f"path p Table IV {m} at {thr}: {hit}, the "
                                f"history gives {first}")
    res["tables"] = {m: dict(acc=r["acc_mean"], std=r["acc_std"],
                             bytes=r["comm_bytes_per_round"])
                     for m, r in rows2}
    res["char_times"] = ct["synth-mnist"]["times"]

    # -- p4: multipod_dfl_train, 8 nodes, 20 rounds: one NCCL rank, then
    # two gloo ranks sharing the card
    if P_DIR.exists():
        shutil.rmtree(P_DIR)
    P_DIR.mkdir(parents=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(P_DIR / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        out, lines, l4, s = p_main(torch, ops, mp_ex, [],
                                   "multipod_dfl_train (NCCL, 1 rank)")
        check(dist.get_backend() == "nccl" and out["n_pods"] == 1,
              f"path p multipod: {out['n_pods']} pods")
    finally:
        dist.destroy_process_group()
    res["s"]["multipod_1"], res["launches"]["multipod_1"] = s, l4
    res["ms"]["multipod_1"] = 1e3 * s / 20
    p_lines(lines, [r"1 device\(s\) -> 1-pod mesh, 8 nodes per pod "
                    r"\(heterogeneous init, ring gossip\)"]
            + [P_ROUND.format(m=re.escape("decdiff+vt"))] * 5
            + [r"node0-node1 model distance: init \d+\.\d\d -> final "
               r"\d+\.\d\d \((converging|diverging)\) — DecDiff pulls "
               r"heterogeneously-initialized nodes together without a "
               r"server, final acc \d\.\d{3} ± \d\.\d{3}"],
            "multipod_dfl_train")
    want = p_expected(ops, [("decdiff+vt", 20, None)])
    check(l4 == want, f"path p multipod: launches {l4}, want {want}")
    one = p_digest(out)
    print(f"path p multipod: node0-node1 distance {one['dist'][0]:.4f} -> "
          f"{one['dist'][1]:.4f}")
    check(one["dist"][1] < one["dist"][0],
          f"path p multipod: the distance grew {one['dist']}")
    t0 = time.perf_counter()
    mp.spawn(p_worker, args=(P_PODS, str(P_DIR)), nprocs=P_PODS, join=True)
    ranks = []
    for r in range(P_PODS):
        with open(P_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    res["s"]["multipod_2"] = time.perf_counter() - t0
    res["ms"]["multipod_2"] = [1e3 * x["s"] / 20 for x in ranks]
    l5 = {k: sum(x["launches"][k] for x in ranks) for k in ops.LAUNCHES}
    res["launches"]["multipod_2"] = l5
    print(f"path p multipod_dfl_train ({P_PODS} gloo ranks on the card): "
          f"{res['s']['multipod_2']:.2f} s with the spawn, main "
          f"{[round(x['s'], 2) for x in ranks]} s by rank; launches (both "
          f"ranks) { {k: l5[k] for k in P_KERNELS} }")
    check(ranks[0]["lines"][0] == "2 device(s) -> 2-pod mesh, 4 nodes per "
                                  "pod (heterogeneous init, ring gossip)"
          and not ranks[1]["lines"],
          f"path p multipod: rank 0 printed {ranks[0]['lines'][:1]}, rank 1 "
          f"{ranks[1]['lines']}")
    check(all(x["digest"]["n_pods"] == P_PODS for x in ranks),
          "path p multipod: pods")
    check(all(x["launches"] == l4 for x in ranks),
          f"path p multipod: each rank's launches "
          f"{[x['launches'] for x in ranks]} against one rank's {l4}")
    bitwise = [p_same(x["digest"], one) for x in ranks]
    print(f"path p multipod: two ranks bitwise the one-rank run: {bitwise}")
    check(all(bitwise), "path p multipod: two ranks differ from one")

    # -- p5: serve_decode at its default arch ----------------------------
    from repro_torch.configs import get_config

    gen, lines, l6, s = p_main(torch, ops, sd, [], "serve_decode")
    res["s"]["serve_decode"], res["launches"]["serve_decode"] = s, l6
    layers = get_config("qwen1.5-0.5b").reduced().n_layers
    p_lines(lines, [r"arch=qwen1\.5-0\.5b batch=4 decoded 32 tokens in "
                    r"\d+\.\d\ds \(\d+\.\d tok/s\)",
                    r"first sequence: \[.*\] \.\.\."], "serve_decode")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["decode_attention_fused"] = layers * (16 + 31)
    check(l6 == want, f"path p serve_decode: launches {l6}, want {want}")
    check(gen.shape == (4, 32), f"path p serve_decode: tokens {gen.shape}")

    # -- card against the CPU at a reduced size ----------------------------
    t0 = time.perf_counter()
    p_card_vs_cpu(torch, dev, qs, cg, dm)
    res["s"]["card_vs_cpu"] = time.perf_counter() - t0
    res["total"] = {k: sum(l[k] for l in res["launches"].values())
                    for k in ops.LAUNCHES}
    res["s"]["all"] = time.perf_counter() - t_path
    shutil.rmtree(P_DIR)
    print(f"path p ({card}): " + "; ".join(
        f"{k} {v:.1f} s" for k, v in res["s"].items())
        + "; ms per round (wall of each main over its rounds, world build "
          "included): " + p_ms_text(res["ms"]))
    return res


def p_ms_text(ms):
    """Path p's ms per round as one line of text."""
    return (f"quickstart {ms['quickstart']:.2f}, compressed_gossip "
            f"{ms['compressed_gossip']:.2f}, decentralized_mnist by method "
            "(its run's own wall) " + ", ".join(
                f"{m} {v:.2f}" for m, v in ms["decentralized_mnist"].items())
            + f" (centralized {ms['centralized_s']:.2f} s), multipod one "
              f"rank {ms['multipod_1']:.2f}, two ranks "
              f"{[round(x, 2) for x in ms['multipod_2']]}")


Q_DIR = ROOT / "build" / "path_q"     # path q's rendezvous and results
Q_BATCH, Q_SEQ, Q_WINDOW, Q_STEPS = 4, 128, 4096, 32
Q_RANKS = 2                           # (data = 1, model = 2) on the card
Q_SHARDS = (2, 16)                    # the split kernels' shard counts
Q_TIMED = 3                           # bf16 train / prefill steps timed
Q_TIMED_DECODE = 8                    # bf16 decode steps timed
Q_KERNELS = ("vt_kl_partial_fwd", "vt_kl_shard_bwd", "decode_scores_partial",
             "decode_softmax_combine")


def q_lm(act):
    """Full-width qwen1.5-0.5b (bf16 params) cut to Q_LAYERS of its 24
    layers, with `act` activations."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(dataclasses.replace(get_config(LM_ARCH),
                                        n_layers=Q_LAYERS,
                                        activation_dtype=act))


def q_steps(torch, ops, lm, dev, mesh=None, timed=False):
    """One train step of Q_BATCH x Q_SEQ (VT loss), prefill of the same
    batch, then Q_STEPS greedy decode steps on a Q_WINDOW-slot ring, on
    `mesh` (params, state, batch and cache placed by the specs) or whole;
    the launch counts set to 0 just before and read just after.  With
    `timed` (the bf16 runs): Q_TIMED_DECODE decode steps only, then
    Q_TIMED more train and prefill steps after the first, each timed
    (host clock, synchronized); every decode step is timed."""
    from repro_torch.dist.dfl_step import (build_prefill_step,
                                           build_serve_step,
                                           build_train_step)
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)
    from repro_torch.optim.sgd import sgd_momentum

    def place(tree, specs):
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh), mesh)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    params = place(lm.init(torch.Generator(device=dev).manual_seed(26),
                            device=dev), make_param_specs)
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    g = torch.Generator(device=dev).manual_seed(27)
    seq = torch.randint(0, lm.cfg.vocab, (Q_BATCH, Q_SEQ + 1), generator=g,
                        device=dev, dtype=torch.int32)
    whole = {"tokens": seq[:, :-1].contiguous(),
             "labels": seq[:, 1:].contiguous()}
    batch = place(whole, make_batch_specs)
    train = build_train_step(lm, opt, beta=LM_BETA, mesh=mesh)
    prefill = build_prefill_step(lm, mesh=mesh)
    serve = build_serve_step(lm, mesh=mesh)
    out = {"ms": {"train": [], "prefill": [], "decode": []}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (_, _, loss), ms = clock(lambda: train(params, state, 0, batch))
    out["ms"]["train"].append(ms)
    logits, ms = clock(lambda: prefill(params, batch))
    out["ms"]["prefill"].append(ms)
    cache = place(lm.init_cache(Q_BATCH, Q_WINDOW, device=dev),
                  make_cache_specs)
    tok = whole["tokens"][:, :1].contiguous()
    dec, toks = [], []
    for _ in range(Q_TIMED_DECODE if timed else Q_STEPS):
        (lg, cache), ms = clock(lambda: serve(
            params, cache, place(tok, make_batch_specs)))
        out["ms"]["decode"].append(ms)
        lg = full_tree(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        dec.append(lg[:, 0].float())
        toks.append(tok)
    torch.cuda.synchronize()
    out["launches"] = dict(ops.LAUNCHES)
    out["peak"] = torch.cuda.max_memory_allocated()
    out.update(loss=float(loss), prefill=full_tree(logits).float(),
               decode=torch.stack(dec), tokens=torch.cat(toks, dim=1),
               params=params)
    if timed:
        for _ in range(Q_TIMED):
            out["ms"]["train"].append(clock(
                lambda: train(params, state, 1, batch))[1])
            out["ms"]["prefill"].append(clock(
                lambda: prefill(params, batch))[1])
    return out


def q_against(torch, got, ref, label):
    """Path q's check of a partitioned run against the unpartitioned one
    (fp32 activations): the loss within 1e-5 (where the run has one),
    prefill and every decode step's logits within 1e-3 of the largest,
    the same tokens."""
    loss_gap = abs(got["loss"] - ref["loss"]) if "loss" in ref else 0.0
    pre = float((got["prefill"] - ref["prefill"]).abs().max())
    pre_max = float(ref["prefill"].abs().max())
    dec = float((got["decode"] - ref["decode"]).abs().max())
    dec_max = float(ref["decode"].abs().max())
    same_tokens = bool(torch.equal(got["tokens"], ref["tokens"]))
    finite = bool(torch.isfinite(got["prefill"]).all()
                  and torch.isfinite(got["decode"]).all())
    text = (f"{label}: " + (f"loss {got['loss']:.6f} (unpartitioned "
                            f"{ref['loss']:.6f}, gap {loss_gap:.3g}); "
                            if "loss" in ref else "") + f"prefill logits "
            f"|diff| {pre:.3g} of max {pre_max:.3g}; {Q_STEPS} decode "
            f"steps |diff| {dec:.3g} of max {dec_max:.3g}; tokens equal "
            f"{same_tokens}")
    ok = (loss_gap <= 1e-5 and pre <= 1e-3 * pre_max
          and dec <= 1e-3 * dec_max and same_tokens and finite)
    return ok, text


def q_worker(rank, n_ranks, out_dir):
    """One rank of path q1 on the card (cuda:0): the (data = 1, model = 2)
    mesh over the host-staged backend; the fp32 steps against the
    unpartitioned run (rank 0, from `ref.pt`), then the bf16 steps timed;
    results pickled to `out_dir/rank<r>.pkl`."""
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import host_staging
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cuda", 0)
    dist.init_process_group(
        host_staging.register(), rank=rank, world_size=n_ranks,
        store=dist.FileStore(str(Path(out_dir) / "store"), n_ranks))
    try:
        mesh = make_host_mesh(data=1, model=n_ranks, device_type="cuda")
        got = q_steps(torch, ops, q_lm("float32"), dev, mesh)
        out = {"launches": got["launches"], "peak": got["peak"],
               "ms_fp32": got["ms"]}
        if rank == 0:
            ref = torch.load(Path(out_dir) / "ref.pt", map_location=dev)
            out["ok"], out["text"] = q_against(torch, got, ref,
                                               "path q1 (1, 2)")
            del ref
        del got
        gc.collect()
        torch.cuda.empty_cache()
        got = q_steps(torch, ops, q_lm("bfloat16"), dev, mesh, timed=True)
        out["ms_bf16"] = got["ms"]
        out["finite_bf16"] = bool(torch.isfinite(got["decode"]).all())
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def q_bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def q_vt_split(torch, ops, z, y, n):
    """B.3's vocab-parallel kernels on z [B, V] cut into n column shards:
    each shard's partial statistics and shard backward against their plain
    versions, the merged statistics' KL against the unsplit plain KL;
    shard 0 timed against its byte bound."""
    from repro_torch.core.virtual_teacher import teacher_entropy
    from repro_torch.kernels import vt_kl_loss as vt

    b, v = z.shape
    vl = v // n
    h = float(teacher_entropy(LM_BETA, v))
    g = torch.full((b,), 1.0 / b, dtype=torch.float32, device=z.device)
    shards = [z[:, i * vl:(i + 1) * vl].contiguous() for i in range(n)]
    parts, ok, err = [], True, 0.0
    for i, s in enumerate(shards):
        got = ops.vt_partial_stats(s, y, i * vl, v)
        want = vt.vt_partial_plain(s, y, i * vl)
        s32 = s.float()
        tols = (0.0, 1e-5 * want[1], 1e-5 * s32.abs().sum(-1) + 1e-6, 0.0)
        for a, w, tol in zip(got, want, tols):
            d = (a - w).abs()
            err = max(err, float(d.max()))
            ok = ok and bool((d <= tol).all())
        parts.append(got)
    m, se, zs, zc = vt.vt_combine(*(torch.stack(t) for t in zip(*parts)))
    kl = vt.vt_kl_from_stats(m, se, zs, zc, LM_BETA, -h, v)
    pk, pm, ps = vt.vt_forward_plain(z, y, LM_BETA, -h)
    kl_err = float((kl - pk).abs().max())
    ok = ok and bool(((kl - pk).abs() <= 1e-5 * pk.abs()
                      + 1e-5 * math.log(v)).all())
    bwd_err, bwd_ok = 0.0, True
    rtol = 2.0 ** -7 if z.dtype == torch.bfloat16 else 1e-5
    for i, s in enumerate(shards):
        got = ops.vt_shard_backward(s, y, i * vl, m, se, g, LM_BETA, v)
        want = vt.vt_shard_backward_plain(s, y, i * vl, m, se, g, LM_BETA,
                                          v).float()
        d = (got.float() - want).abs()
        bwd_err = max(bwd_err, float(d.max()))
        bwd_ok = bwd_ok and bool((d <= rtol * want.abs() + 1e-6 * g[0]).all())
    s0 = shards[0]
    elt = z.element_size()
    t_f = timings(torch, lambda: ops.vt_partial_stats(s0, y, 0, v),
                  lambda: vt.vt_partial_plain(s0, y, 0), None)
    t_b = timings(torch, lambda: ops.vt_shard_backward(
        s0, y, 0, m, se, g, LM_BETA, v), lambda: vt.vt_shard_backward_plain(
        s0, y, 0, m, se, g, LM_BETA, v), None)
    out = {}
    for kind, t, e, nbytes, per in [
            ("fwd", t_f, max(err, kl_err), b * vl * elt + 8 * b + 16 * b, 4),
            ("bwd", t_b, bwd_err, 2 * b * vl * elt + 8 * b + 12 * b, 5)]:
        bound_ms, bound_by = q_bound(nbytes, per * b * vl)
        out[kind] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=e, shape=[b, vl], shards=n,
                         dtype=str(z.dtype))
        name = "vt_kl_partial_fwd" if kind == "fwd" else "vt_kl_shard_bwd"
        print(f"{name} at {n} shards of [B={b}, V={v}, {z.dtype}] (a shard "
              f"[{b}, {vl}]): max_abs_err={e:g} (merged KL "
              f"{kl_err:g}); kernel {t['ms']:.4f} ms call / "
              f"{t['kernel_ms']:.4f} ms device, plain {t['plain_ms']:.4f} "
              f"ms; bound {bound_ms:.4f} ms ({bound_by}), device time at "
              f"{100 * bound_ms / t['kernel_ms']:.1f}% of bound")
    check(ok, f"vt_kl_partial_fwd at {n} shards: kernel and plain differ "
              f"by {err:g}, merged KL by {kl_err:g}")
    check(bwd_ok, f"vt_kl_shard_bwd at {n} shards: kernel and plain differ "
                  f"by {bwd_err:g}")
    return out


# B.3's split kernels: (rows, V_total, shards) of the paths' shards (u's
# whisper and llava, q's 16 and 2 shards, s's mixtral, t's mamba2 and
# zamba2), then two many-row shapes: a 4096-token sequence at whisper's
# 2-shard and qwen's 16-shard widths
VT_SPLIT_SHAPES = ((896, 51866, 2), (256, 32000, 2), (512, 151936, 16),
                   (512, 151936, 2), (512, 32000, 2), (1024, 50280, 2),
                   (1024, 32000, 2))
VT_SPLIT_NEW = ((4096, 51866, 2), (4096, 151936, 16))


def q_vt_bitwise(torch, ops, z, y, v, offset):
    """The split forward's four outputs on a shard z [B, V] (the columns
    [offset, offset + V) of v) bitwise equal between one call, calls on
    blocks of its rows (a row, a third, the rest), a second call, and
    calls on copies of it that start 2, 4, ... 14 bytes (fp32: 4, 8, 12)
    past a 16-byte boundary: at an odd width, every row phase."""
    b, vl = z.shape
    elt = z.element_size()
    whole = ops.vt_partial_stats(z, y, offset, v)
    cuts = [0, 1, 1 + b // 3, b]
    parts = [ops.vt_partial_stats(z[lo:hi], y[lo:hi], offset, v)
             for lo, hi in zip(cuts, cuts[1:])]
    runs = [("blocks of rows", [torch.cat(t) for t in zip(*parts)]),
            ("a second call", ops.vt_partial_stats(z, y, offset, v))]
    for shift in range(elt, 16, elt):
        buf = torch.empty(b * vl + 16 // elt, dtype=z.dtype, device=z.device)
        moved = buf[shift // elt:shift // elt + b * vl].view(b, vl)
        moved.copy_(z)
        check(moved.data_ptr() % 16 == shift,
              f"a copy meant {shift} bytes off 16 is at "
              f"{moved.data_ptr() % 16}")
        runs.append((f"{shift} bytes off",
                     ops.vt_partial_stats(moved, y, offset, v)))
    torch.cuda.synchronize()
    bad = [label for label, got in runs
           if not all(torch.equal(a, w) for a, w in zip(got, whole))]
    print(f"vt_kl_partial_fwd bitwise at a shard [{b}, {vl}] of {v} "
          f"({z.dtype}): {len(runs)} calls against one, differing: "
          f"{bad or 'none'}")
    check(not bad, f"vt_kl_partial_fwd [{b}, {vl}] {z.dtype}: bits differ "
                   f"from one call's on {bad}")


def vt_split_shapes(torch, ops, dev):
    """`--vt-split`: B.3's split kernels at VT_SPLIT_SHAPES and
    VT_SPLIT_NEW, fp32 and bf16, each through `q_vt_split` (checks and
    times), their device times printed as one JSON line; then
    `q_vt_bitwise` at whisper's odd shard with few and many rows."""
    gen = torch.Generator(device=dev).manual_seed(37)
    times = {}
    for rows, v, n in VT_SPLIT_SHAPES + VT_SPLIT_NEW:
        y = torch.randint(0, v, (rows,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            z = (torch.randn((rows, v), generator=gen, device=dev)
                 * 3).to(dtype)
            c = q_vt_split(torch, ops, z, y, n)
            times[f"{rows}x{v // n} {str(dtype)[6:]}"] = {
                k: {"kernel_ms": c[k]["kernel_ms"], "ms": c[k]["ms"],
                    "bound_ms": c[k]["bound_ms"]} for k in ("fwd", "bwd")}
            del z
    print("vt_split_times " + json.dumps(times))
    for rows in (896, 4096):
        y = torch.randint(0, 51866, (rows,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            z = (torch.randn((rows, 25933), generator=gen, device=dev)
                 * 3).to(dtype)
            q_vt_bitwise(torch, ops, z, y, 51866, 25933)
            del z


def q_decode_split(torch, ops, q, k, v, sp, pos, n, timed=True, cold=False,
                   row=3):
    """B.9's split-hd kernels on a cache cut into n hd shards: each shard's
    partial scores against the plain version, their sum's softmax-combine
    against the plain version, and the joined output against the unsplit
    plain attention.  With `timed`, shard 0 also checked bitwise against
    itself (batch row `row` alone = that row of the whole batch; a second
    call = the first) and timed against its byte bound, the scores beside
    the library's: one `torch.matmul` of q·scale [B, K, G, hd/n] and the
    transposed k view [B, K, hd/n, W] (in the inputs' dtype, so bf16
    scores for bf16 inputs where the kernel writes fp32; the transposition
    copied inside the call), and the same product on a k transposed
    beforehand; with `cold`, also with the L2 flushed before each call.
    Without `timed`, the checks' errors."""
    from repro_torch.kernels import decode_attention as da

    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    hl = hd // n
    scale = 1.0 / math.sqrt(hd)
    cut = [(q[..., i * hl:(i + 1) * hl].contiguous(),
            k[..., i * hl:(i + 1) * hl].contiguous(),
            v[..., i * hl:(i + 1) * hl].contiguous()) for i in range(n)]
    s_err, s_ok, total = 0.0, True, None
    for qs, ks, _ in cut:
        got = ops.decode_scores_partial(qs, ks, scale)
        want = da.scores_partial_plain(qs, ks, scale)
        terms = scale * torch.einsum(
            "bkgd,bwkd->bkgw", qs.float().abs().reshape(b, kk, h // kk, hl),
            ks.float().abs()).reshape(b, h, w)
        d = (got - want).abs()
        s_err = max(s_err, float(d.max()))
        s_ok = s_ok and bool((d <= 1e-5 * terms + 1e-6).all())
        total = got if total is None else total + got
        del want, terms, d
    c_err, c_ok, outs = 0.0, True, []
    vmax = float(v.abs().max())
    for _, _, vs in cut:
        got = ops.decode_softmax_combine(total, vs, sp, pos)
        want = da.softmax_combine_plain(total, vs, sp, pos)
        d = (got - want).abs()
        c_err = max(c_err, float(d.max()))
        c_ok = c_ok and bool((d <= 2e-5 * want.abs()
                              + 2e-5 * max(vmax, 1.0)).all())
        outs.append(got)
    joined = torch.cat(outs, dim=-1)
    ref = da.decode_attention_plain(q, k, v, sp, pos)
    j_err = float((joined - ref).abs().max())
    j_ok = bool(((joined - ref).abs() <= 2e-5 * ref.abs()
                 + 2e-5 * max(vmax, 1.0)).all())
    del outs, joined, ref
    label = (f"{n} hd shards of [B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
             f"{k.dtype}] (a shard's hd {hl})")
    check(s_ok, f"decode_scores_partial at {label}: kernel and plain "
                f"differ by {s_err:g}")
    check(c_ok and j_ok, f"decode_softmax_combine at {label}: kernel and "
                         f"plain differ by {c_err:g}, joined by {j_err:g}")
    if not timed:
        print(f"decode_scores_partial / decode_softmax_combine at {label}: "
              f"max_abs_err {s_err:g} / {c_err:g} (joined output against "
              f"the unsplit attention {j_err:g})")
        return {kind: dict(max_abs_err=e, shape=[b, h, w, kk, hl], shards=n,
                           dtype=str(k.dtype))
                for kind, e in (("scores", s_err),
                                ("combine", max(c_err, j_err)))}
    q0, k0, v0 = cut[0]
    # bitwise: a batch row alone as in the whole batch, a call as the last
    r = slice(row, row + 1)
    s_all = ops.decode_scores_partial(q0, k0, scale)
    c_all = ops.decode_softmax_combine(total, v0, sp, pos)
    bitwise = {
        "scores_row": torch.equal(s_all[r], ops.decode_scores_partial(
            q0[r].contiguous(), k0[r].contiguous(), scale)),
        "combine_row": torch.equal(c_all[r], ops.decode_softmax_combine(
            total[r].contiguous(), v0[r].contiguous(), sp, pos)),
        "scores_again": torch.equal(s_all, ops.decode_scores_partial(
            q0, k0, scale)),
        "combine_again": torch.equal(c_all, ops.decode_softmax_combine(
            total, v0, sp, pos))}
    del s_all, c_all
    check(all(bitwise.values()), f"B.9's split kernels at {label}: not "
                                 f"bitwise across batch sizes or calls "
                                 f"{bitwise}")
    q4 = (q0 * scale).reshape(b, kk, h // kk, hl)
    kt = k0.permute(0, 2, 3, 1)
    t_s = timings(torch, lambda: ops.decode_scores_partial(q0, k0, scale),
                  lambda: da.scores_partial_plain(q0, k0, scale),
                  lambda: torch.matmul(q4, kt), cold=cold)
    kt = kt.contiguous()
    t_s["library_pretransposed_kernel_ms"] = device_ms(
        torch, lambda: torch.matmul(q4, kt))[0]
    del kt
    t_c = timings(torch, lambda: ops.decode_softmax_combine(total, v0, sp,
                                                            pos),
                  lambda: da.softmax_combine_plain(total, v0, sp, pos), None,
                  cold=cold)
    # a floor for the combine: PyTorch's own reductions reading the same
    # bytes (the scores and v, each summed to one fp32), not the function
    def read_all():
        return [torch.sum(x, dtype=torch.float32) for x in (total, v0)]

    t_c["read_floor_kernel_ms"] = device_ms(torch, read_all)[0]
    if cold:
        t_c["read_floor_kernel_ms_cold"] = device_ms(
            torch, read_all, before=l2_flush(torch))[0]
    plan = (da.split_plan(w, kk, h // kk, hl, k.element_size(),
                          torch.cuda.get_device_properties(
                              q.device).multi_processor_count)._asdict()
            if hasattr(da, "split_plan") else None)  # older trees: none
    elt = k.element_size()
    s_bytes = 4 * b * h * w
    out = {}
    for kind, t, e, nbytes, flops in [
            ("scores", t_s, s_err, q0.numel() * q0.element_size()
             + k0.numel() * elt + s_bytes, 2 * b * h * w * hl),
            ("combine", t_c, max(c_err, j_err), s_bytes + v0.numel() * elt
             + 4 * w + 4 + 4 * b * h * hl, 2 * b * h * w * hl + 3 * b * h * w)]:
        bound_ms, bound_by = q_bound(nbytes, flops)
        out[kind] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=e, shape=[b, h, w, kk, hl], shards=n,
                         dtype=str(k.dtype), bitwise=bitwise, plan=plan)
        name = ("decode_scores_partial" if kind == "scores"
                else "decode_softmax_combine")
        lib = ("" if t["library_ms"] is None else
               f", torch.matmul {t['library_ms']:.4f} ms call / "
               f"{t['library_kernel_ms']:.4f} ms device (on a k transposed "
               f"beforehand {t['library_pretransposed_kernel_ms']:.4f} ms "
               f"device)")
        text = (f"kernel {t['ms']:.4f} ms call / {t['kernel_ms']:.4f} ms "
                f"device ({t['kernels_per_call']} kernels a call), plain "
                f"{t['plain_ms']:.4f} ms{lib}; bound {bound_ms:.4f} ms "
                f"({bound_by}), device time at "
                f"{100 * bound_ms / t['kernel_ms']:.1f}% of bound")
        if cold:
            text += (f"; L2 cold: kernel {t['ms_cold']:.4f} / "
                     f"{t['kernel_ms_cold']:.4f} ms (call / device, "
                     f"{100 * bound_ms / t['kernel_ms_cold']:.1f}% of "
                     f"bound)")
            if t["library_ms"] is not None:
                text += (f", torch.matmul {t['library_ms_cold']:.4f} / "
                         f"{t['library_kernel_ms_cold']:.4f} ms")
        if "read_floor_kernel_ms" in t:
            text += (f"; torch.sum of the same bytes "
                     f"{t['read_floor_kernel_ms']:.4f} ms device")
            if cold:
                text += f", L2 cold {t['read_floor_kernel_ms_cold']:.4f}"
        print(f"{name} at {label}: max_abs_err={e:g} (joined output "
              f"against the unsplit attention {j_err:g}); {text}; bitwise "
              f"across B and calls; plan {plan}")
    return out


def q_decode_shapes(torch, ops, dev, gen):
    """B.9's split kernels at Q_SHARDS shards of path e's [8, 32768, 16,
    64] bf16 cache, timed; at q1's own [4, 4096, 16, 64] cache cut in 2,
    fp32 and bf16, checked; and at Q_SHARDS shards of qwen3-32b's GQA cache
    [8, 32768, 8, 128] (64 query heads), timed.  The 16-shard shapes are
    also timed with the L2 cold (their k shard fits the 50 MB L2).  Inputs
    from the seeded generator `gen`, in that order; path e's live context
    (slots 0..32719) on both long caches, q1's first Q_STEPS slots on its
    own."""
    def cache(shape_q, shape_kv, dtype=torch.bfloat16):
        return (torch.randn(shape_q, generator=gen, device=dev).to(dtype),
                *(torch.randn(shape_kv, generator=gen, device=dev).to(dtype)
                  for _ in range(2)))

    def long_cache(h, kk, hd):
        q, k, v = cache((SERVE_BATCH, h, hd),
                        (SERVE_BATCH, SERVE_WINDOW, kk, hd))
        out = {n: q_decode_split(torch, ops, q, k, v, sp, pos, n,
                                 cold=n > 2) for n in Q_SHARDS}
        del q, k, v
        torch.cuda.empty_cache()
        return out

    sp = torch.arange(SERVE_WINDOW, dtype=torch.int32, device=dev)
    sp[32720:] = -1  # path e's live context
    pos = torch.tensor(32719, dtype=torch.int32, device=dev)
    checks = long_cache(16, 16, 64)
    # ... at q1's own shard shape (Q_BATCH x Q_WINDOW, hd 64 over Q_RANKS,
    # the ring's first Q_STEPS slots live), both dtypes
    da_q1 = {}
    sp1 = torch.full((Q_WINDOW,), -1, dtype=torch.int32, device=dev)
    sp1[:Q_STEPS] = torch.arange(Q_STEPS, dtype=torch.int32, device=dev)
    pos1 = torch.tensor(Q_STEPS - 1, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = cache((Q_BATCH, 16, 64), (Q_BATCH, Q_WINDOW, 16, 64),
                        dtype)
        da_q1[str(dtype)] = q_decode_split(torch, ops, q, k, v, sp1, pos1,
                                           Q_RANKS, timed=False)
        del q, k, v
    gqa = long_cache(64, 8, 128)  # qwen3-32b
    return checks, da_q1, gqa


def path_q(torch, ops, dev, card):
    """The partitioned dense LM step (see the module docstring): q0 the
    unpartitioned run and the (1, 1) NCCL mesh in this process, bitwise;
    q1 the (1, 2) mesh in Q_RANKS ranks on the card over the host-staged
    backend, against the unpartitioned run; the bf16 steps timed both
    ways; then B.3's and B.9's split kernels at Q_SHARDS shards.  Returns
    the launches by rank and the kernels' checks."""
    import pickle
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.dist.sharding import full_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves

    t_q = time.perf_counter()
    if Q_DIR.exists():
        shutil.rmtree(Q_DIR)
    Q_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    print(f"path q cuts: qwen1.5-0.5b {Q_LAYERS} of {LM_LAYERS} layers (the "
          f"script's time limit), model = 2 on one card ({card})")
    # -- q0: unpartitioned, then the (1, 1) NCCL mesh, fp32 activations
    lm = q_lm("float32")
    ref = q_steps(torch, ops, lm, dev)
    want = {"vt_kl_loss_fwd": 1, "vt_kl_loss_bwd": 1,
            "decode_attention_fused": Q_LAYERS * Q_STEPS}
    check(ref["launches"] == {k: want.get(k, 0) for k in ops.LAUNCHES},
          f"path q (unpartitioned): launches {ref['launches']}")
    torch.save({k: ref[k] for k in ("loss", "prefill", "decode", "tokens")},
               Q_DIR / "ref.pt")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(Q_DIR / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        got = q_steps(torch, ops, lm, dev, make_host_mesh(data=1, model=1))
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full_tree(got["params"])),
            tree_leaves(ref["params"])))
    finally:
        dist.destroy_process_group()
    same = {"loss": got["loss"] == ref["loss"], "params": same_params,
            **{k: bool(torch.equal(got[k], ref[k]))
               for k in ("prefill", "decode", "tokens")}}
    bitwise = all(same.values())
    print(f"path q0 ((data, model) = (1, 1) on NCCL, {card}): loss "
          f"{got['loss']:.6f}, bitwise the unpartitioned step (loss, "
          f"updated params, prefill logits, {Q_STEPS} decode steps' logits "
          f"and tokens) = {bitwise}; launches {got['launches']}")
    check(bitwise, f"path q0: the (1, 1) mesh differs from the "
                   f"unpartitioned step: equal {same}")
    check(got["launches"] == ref["launches"],
          f"path q0: launches {got['launches']} against {ref['launches']}")
    del got, ref, lm
    gc.collect()
    torch.cuda.empty_cache()
    # -- the unpartitioned bf16 steps, timed
    base = q_steps(torch, ops, q_lm("bfloat16"), dev, timed=True)
    base_ms, base_peak = base["ms"], base["peak"]
    check(bool(torch.isfinite(base["decode"]).all()),
          "path q: unpartitioned bf16 logits not finite")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    # -- q1: (1, 2) over the host-staged backend, two ranks on this card
    t0 = time.perf_counter()
    mp.spawn(q_worker, args=(Q_RANKS, str(Q_DIR)), nprocs=Q_RANKS,
             join=True)
    ranks = []
    for r in range(Q_RANKS):
        with open(Q_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    q1_s = time.perf_counter() - t0
    print(ranks[0]["text"])
    check(ranks[0]["ok"], f"path q1 against the unpartitioned step: "
                          f"{ranks[0]['text']}")
    want = {"vt_kl_partial_fwd": 1, "vt_kl_shard_bwd": 1,
            "decode_scores_partial": Q_LAYERS * Q_STEPS,
            "decode_softmax_combine": Q_LAYERS * Q_STEPS}
    for r, res in enumerate(ranks):
        check(res["launches"] == {k: want.get(k, 0) for k in ops.LAUNCHES},
              f"path q1 rank {r}: launches {res['launches']}")
        check(res["imported"] == [] and res["finite_bf16"],
              f"path q1 rank {r}: imported {res['imported']}, finite bf16 "
              f"logits {res['finite_bf16']}")

    def med(ms):
        return {k: round(statistics.median(v[1:] if len(v) > 1 else v), 3)
                for k, v in ms.items()}

    print(f"path q (bf16 ms per step, median; {card}): unpartitioned "
          f"{med(base_ms)}, peak {base_peak} B; (1, 2) over the host-staged "
          f"backend, rank 0 {med(ranks[0]['ms_bf16'])}, rank 1 "
          f"{med(ranks[1]['ms_bf16'])}, peak {ranks[0]['peak']} / "
          f"{ranks[1]['peak']} B (fp32 run); launches per rank "
          f"{[{k: r['launches'][k] for k in Q_KERNELS} for r in ranks]}; "
          f"q1 in {q1_s:.1f} s")
    # -- the split kernels in this process, at Q_SHARDS shards
    gen = torch.Generator(device=dev).manual_seed(28)
    v_full = 151936
    y = torch.randint(0, v_full, (LM_BATCH * LM_SEQ,), generator=gen,
                      device=dev)
    vt_checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        z = (torch.randn((LM_BATCH * LM_SEQ, v_full), generator=gen,
                         device=dev) * 3).to(dtype)
        for n in Q_SHARDS:
            vt_checks[str(dtype), n] = q_vt_split(torch, ops, z, y, n)
        del z
    gen_new = torch.Generator(device=dev).manual_seed(36)
    for rows, v, n in VT_SPLIT_NEW:
        y_new = torch.randint(0, v, (rows,), generator=gen_new, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            z = (torch.randn((rows, v), generator=gen_new, device=dev)
                 * 3).to(dtype)
            vt_checks[str(dtype), n, rows] = q_vt_split(torch, ops, z,
                                                        y_new, n)
            del z
    torch.cuda.empty_cache()
    da_checks, da_q1, da_gqa = q_decode_shapes(torch, ops, dev, gen)
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ops.LAUNCHES}
    print(f"path q in all {time.perf_counter() - t_q:.1f} s")
    return {"launches": launches, "vt": vt_checks, "da": da_checks,
            "da_q1": da_q1, "da_gqa": da_gqa,
            "ms": {"unpartitioned_bf16": med(base_ms),
                   "partitioned_bf16": med(ranks[0]["ms_bf16"])}}


R_DIR = ROOT / "build" / "path_r"     # path r's rendezvous and results
R_NODES, R_BATCH, R_SEQ = 2, 4, 128   # two nodes on a ring, 4 x 128 each
R_LAYERS = 2                          # of 24: the script's time limit
R_MESH = (2, 1, 2)                    # (pod, data, model) on the card
R_EXCHANGES = ("fp32", "bf16", "int8")
R_TIMED = 3                           # bf16 rounds timed after one
R_ROUND = ("vt_kl_partial_fwd", "vt_kl_shard_bwd", "decdiff_update")
R_SERVE = ("decode_scores_partial", "decode_softmax_combine")


def r_lm(checks):
    """Full-width qwen1.5-0.5b cut to R_LAYERS layers: fp32 params and
    activations for the checks, else the registered bf16 config (the
    timed rounds)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=R_LAYERS)
    if checks:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  activation_dtype="float32")
    return build_lm(cfg)


def r_exchange(torch, name):
    from repro_torch.comm.codecs import Int8Codec

    return {"fp32": {}, "bf16": {"gossip_dtype": torch.bfloat16},
            "int8": {"codec": Int8Codec(stochastic=False)}}[name]


def r_round(torch, ops, lm, dev, name, mesh=None, shardmap=False, timed=0):
    """One DFL round of exchange `name` over R_NODES nodes on a ring, each
    with a batch of R_BATCH x R_SEQ (VT loss): on `mesh` (the multi mesh)
    this rank's pod block placed on its sub-mesh, else all nodes (with
    `shardmap`, the one-pod fused `build_dfl_round_shardmap`); node i's
    params from seed 30 + i.  The launch counts set to 0 just before the
    round and read just after; with `timed`, that many more rounds, each
    timed (host clock, synchronized)."""
    from repro_torch.dist.dfl_step import (build_dfl_round,
                                           build_dfl_round_shardmap)
    from repro_torch.dist.sharding import place_node_block
    from repro_torch.launch.mesh import pod_axis
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_map

    n_pods, pod = (1, 0) if mesh is None else pod_axis(mesh)[:2]
    r = R_NODES // n_pods
    nodes = [lm.init(torch.Generator(device=dev).manual_seed(30 + i),
                     device=dev) for i in range(pod * r, (pod + 1) * r)]
    params = tree_map(lambda *xs: torch.stack(xs), *nodes)
    del nodes
    g = torch.Generator(device=dev).manual_seed(31)
    seq = torch.randint(0, lm.cfg.vocab, (R_NODES, R_BATCH, R_SEQ + 1),
                        generator=g, device=dev, dtype=torch.int32)
    seq = seq[pod * r:(pod + 1) * r]
    batch = {"tokens": seq[..., :-1].contiguous(),
             "labels": seq[..., 1:].contiguous()}
    if mesh is not None:
        params = place_node_block(params, mesh)
        batch = place_node_block(batch, mesh, batch=True)
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    adj = [[0.0, 1.0], [1.0, 0.0]]
    kw = r_exchange(torch, name)
    step = (build_dfl_round_shardmap(lm, opt, adj, beta=LM_BETA, **kw)
            if shardmap else
            build_dfl_round(lm, opt, adj, beta=LM_BETA, mesh=mesh, **kw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    new, state, loss = step(params, state, 0, batch)
    torch.cuda.synchronize()
    out = {"launches": dict(ops.LAUNCHES),
           "ms": [1e3 * (time.perf_counter() - t0)], "loss": float(loss)}
    for i in range(timed):
        t0 = time.perf_counter()
        new, state, _ = step(new, state, i + 1, batch)
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
    out.update(params=new, peak=torch.cuda.max_memory_allocated())
    return out


def r_serve(torch, ops, lm, dev, mesh=None):
    """Node 0's params (seed 30): prefill of its first R_BATCH x R_SEQ
    tokens, then Q_STEPS greedy decode steps on a Q_WINDOW-slot ring; on
    `mesh` params replicated over "pod", batch and tokens over ("pod",
    "data"), the cache by its specs.  Launch counts set to 0 just before
    and read just after."""
    from repro_torch.dist.dfl_step import build_prefill_step, build_serve_step
    from repro_torch.dist.sharding import (NODE_AXIS, distribute_tree,
                                           full_tree, make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)

    def place(tree, specs, **kw):
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh, **kw), mesh)

    dp = {"dp_axes": (NODE_AXIS, "data")}
    params = place(lm.init(torch.Generator(device=dev).manual_seed(30),
                           device=dev), make_param_specs)
    g = torch.Generator(device=dev).manual_seed(31)
    seq = torch.randint(0, lm.cfg.vocab, (R_NODES, R_BATCH, R_SEQ + 1),
                        generator=g, device=dev, dtype=torch.int32)[0]
    whole = {"tokens": seq[:, :-1].contiguous(),
             "labels": seq[:, 1:].contiguous()}
    prefill = build_prefill_step(lm, mesh=mesh)
    serve = build_serve_step(lm, mesh=mesh)
    torch.cuda.synchronize()
    ops.reset_launches()
    logits = full_tree(prefill(params, place(whole, make_batch_specs, **dp)))
    cache = place(lm.init_cache(R_BATCH, Q_WINDOW, device=dev),
                  make_cache_specs)
    tok = whole["tokens"][:, :1].contiguous()
    dec, toks = [], []
    for _ in range(Q_STEPS):
        lg, cache = serve(params, cache,
                          place({"t": tok}, make_batch_specs, **dp)["t"])
        lg = full_tree(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        dec.append(lg[:, 0].float())
        toks.append(tok)
    torch.cuda.synchronize()
    return {"launches": dict(ops.LAUNCHES), "prefill": logits.float(),
            "decode": torch.stack(dec), "tokens": torch.cat(toks, dim=1)}


def r_shard(t, placements, coord, sizes):
    """The shard at `coord` of the sub-mesh (dimension sizes `sizes`) of a
    whole tensor `t` placed by `placements` (DTensor's even chunks)."""
    for pl, c, n in zip(placements, coord, sizes):
        if pl.is_shard():
            t = t.chunk(n, dim=pl.dim)[c]
    return t


def r_worker(rank, n_ranks, out_dir, device="cuda:0"):
    """One rank of path r1 on the card (cuda:0): the (2, 1, 2) multi mesh
    over the host-staged backend; the three fp32-config rounds, each
    against the unpartitioned round (its pod's node, from `ref_<x>.pt`,
    shard for shard), prefill and decode against the unpartitioned steps
    (rank 0, from `serve.pt`), then the bf16 round timed; results pickled
    to `out_dir/rank<r>.pkl`."""
    import pickle

    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import host_staging
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, pod_submesh
    from repro_torch.utils.pytree import tree_leaves

    dist.init_process_group(
        host_staging.register(), rank=rank, world_size=n_ranks,
        store=dist.FileStore(str(Path(out_dir) / "store"), n_ranks))
    try:
        mesh = make_host_mesh(pod=R_MESH[0], data=R_MESH[1],
                              model=R_MESH[2], device_type=dev.type)
        sub = pod_submesh(mesh)
        coord, sizes = sub.get_coordinate(), tuple(sub.shape)
        pod, r = mesh.get_coordinate()[0], R_NODES // R_MESH[0]
        out = {"rounds": {}}
        lm = r_lm(True)
        for name in R_EXCHANGES:
            got = r_round(torch, ops, lm, dev, name, mesh)
            ref = torch.load(Path(out_dir) / f"ref_{name}.pt",
                             map_location="cpu", mmap=True)
            err = 0.0
            for t, w in zip(tree_leaves(got["params"]),
                            tree_leaves(ref["params"])):
                want = r_shard(w[pod * r:(pod + 1) * r], t.placements, coord,
                               sizes)
                err = max(err, float((t.to_local().float()
                                      - want.to(dev)).abs().max()))
            tol = 1e-5 if name != "int8" else 1e-4 + max(
                ref["grain"][pod * r:(pod + 1) * r])
            out["rounds"][name] = dict(
                loss=got["loss"], loss_gap=abs(got["loss"] - ref["loss"]),
                err=err, tol=tol, ms=got["ms"], peak=got["peak"],
                launches=got["launches"],
                ok=abs(got["loss"] - ref["loss"]) <= 1e-5 and err <= tol)
            del got, ref
            gc.collect()
            torch.cuda.empty_cache()
        got = r_serve(torch, ops, lm, dev, mesh)
        out["serve_launches"] = got["launches"]
        if rank == 0:
            ref = torch.load(Path(out_dir) / "serve.pt", map_location=dev)
            out["serve_ok"], out["serve_text"] = q_against(
                torch, got, ref, "path r1 (2, 1, 2) prefill and decode")
            del ref
        del got, lm
        gc.collect()
        torch.cuda.empty_cache()
        got = r_round(torch, ops, r_lm(False), dev, "bf16", mesh,
                      timed=R_TIMED)
        out["ms_bf16"], out["peak_bf16"] = got["ms"], got["peak"]
        out["finite_bf16"] = bool(math.isfinite(got["loss"]))
        del got
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def r_split_check(torch, dev, gen, lm=None, label="path r1's flat block"):
    """The split B.2 (`ops.decdiff_rows_split`) at path r1's shape (or at
    the node block of `lm`, placed with its `expert_parallel`): the flat
    [1, D_local] fp32 block (the int8 round's form) of the rank at model
    coordinate 1 of 2, whose spans leave out the leaves replicated over
    "model", the all-reduce the identity; against its plain version (the
    norm within 1e-5 relative, the step within what that moves) and timed
    against its byte bound.  No single PyTorch call computes it
    (library_ms null)."""
    from repro_torch.dist.dfl_step import _counted_here, _flat_spans
    from repro_torch.dist.sharding import node_block_specs, placements
    from repro_torch.kernels import decdiff_update as dd
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_map

    def spec_leaves(tree):  # sorted keys, as tree_leaves
        if isinstance(tree, dict):
            return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
        return [tree]

    lm = lm or r_lm(True)
    meta = tree_map(lambda t: torch.empty((1,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"),
                    lm.init(torch.Generator(), device="meta"))
    sizes = dict(zip(("pod", "data", "model"), R_MESH))
    sub = type("Sub", (), {"mesh_dim_names": ("data", "model")})()
    counted, widths = [], []
    for t, spec in zip(tree_leaves(meta), spec_leaves(node_block_specs(
            meta, type("M", (), {"shape": sizes})(),
            expert_parallel=lm.cfg.expert_parallel))):
        widths.append(t[0].numel() // math.prod(
            sizes[a] for a in ("data", "model") if a in spec))
        counted.append(_counted_here(placements(spec, sub), (0, 1)))
    spans = _flat_spans(counted, widths)
    d, dc = sum(widths), sum(c1 - c0 for _, c0, c1 in spans)
    x = torch.randn((1, d), generator=gen, device=dev)
    a = x + 0.01 * torch.randn((1, d), generator=gen, device=dev)
    seen = []

    def identity(t):
        seen.append(t.clone())
        return t

    got = ops.decdiff_rows_split([x], [a], None, 1.0, spans, identity)[0]
    torch.cuda.synchronize()
    sq_p = dd.sumsq_spans_plain([x], [a], spans)
    want = dd.decdiff_rows_split_plain([x], [a], None, 1.0, spans,
                                       lambda t: t)[0]
    norm_err = float((seen[0] - sq_p).abs().max())
    step_err = float((got - want).abs().max())
    # a norm 1e-5 off moves the step by 1e-5 of it; fp32 rounds either side
    scale = float(1.0 / (torch.sqrt(sq_p) + 1.0))
    step_ok = bool(((got - want).abs() <= 1e-6 + 1e-5 * scale * (a - x).abs()
                    + 2.0 ** -22 * x.abs()).all())
    del got, want, seen[:]
    t = timings(torch, lambda: ops.decdiff_rows_split(
        [x], [a], None, 1.0, spans, identity),
        lambda: dd.decdiff_rows_split_plain([x], [a], None, 1.0, spans,
                                            identity), None)
    nbytes, flops = dc * 8 + d * 12, 3 * dc + 3 * d
    bound, by = q_bound(nbytes, flops)
    res = dict(t, max_abs_err=step_err, norm_err=norm_err, bound_ms=bound,
               bound_by=by, shape=[1, d], counted_columns=dc,
               spans=len(spans), dtype="torch.float32")
    print(f"decdiff_update split ({label} [1, {d}] fp32, "
          f"{len(spans)} spans, {dc} counted columns): step |diff| "
          f"{step_err:g}, norm |diff| {norm_err:g} of {float(sq_p):.6g}; "
          f"kernel {t['ms']:.4f} ms call / {t['kernel_ms']:.4f} ms device, "
          f"plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms ({by}, "
          f"{nbytes / 1e9:.3f} GB), device time at "
          f"{100 * bound / t['kernel_ms']:.1f}% of bound")
    check(norm_err <= 1e-5 * float(sq_p),
          f"split decdiff_update: the norm differs by {norm_err:g}")
    check(step_ok, f"split decdiff_update: the step differs by "
                   f"{step_err:g}")
    return res


def path_r(torch, ops, dev, card):
    """The LM DFL round partitioned inside each pod on the multi mesh (see
    the module docstring): r0 the unpartitioned rounds and the (1, 1, 1)
    NCCL mesh in this process, bitwise; r1 the (2, 1, 2) mesh in four
    ranks on the card over the host-staged backend, against the
    unpartitioned round, then prefill and decode; the bf16 round timed
    both ways; then the split B.2 at r1's shape.  Returns the launches by
    rank, the split kernel's check and the ms."""
    import pickle
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.dist.sharding import full_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t_r = time.perf_counter()
    if R_DIR.exists():
        shutil.rmtree(R_DIR)
    R_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    print(f"path r cuts: qwen1.5-0.5b {R_LAYERS} of {LM_LAYERS} layers (the "
          f"script's time limit), (pod, data, model) = {R_MESH} on one card "
          f"({card})")
    lm = r_lm(True)

    def want_launches(name, kernels):
        base = {"vt_kl_loss_fwd": R_NODES, "vt_kl_loss_bwd": R_NODES,
                "decdiff_update": 1}
        if name == "int8" and kernels == "fused":
            base["dequant_neighbor_avg_rows"] = 1
        return {k: base.get(k, 0) for k in ops.LAUNCHES}

    # -- r0: the unpartitioned rounds (r1's references), then the (1, 1, 1)
    # NCCL mesh against them (int8: against the one-pod fused round)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(R_DIR / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    same = {}
    try:
        mesh = make_host_mesh(pod=1, data=1, model=1, device_type=dev.type)
        for name in R_EXCHANGES:
            ref = r_round(torch, ops, lm, dev, name)
            check(ref["launches"] == want_launches(name, "unfused"),
                  f"path r ({name}, unpartitioned): launches "
                  f"{ref['launches']}")
            grain = [float(max(t[i].abs().max() for t in
                               tree_leaves(ref["params"]))) / 127.0
                     for i in range(R_NODES)]
            torch.save({"loss": ref["loss"], "grain": grain,
                        "params": tree_map(lambda t: t.cpu(),
                                           ref["params"])},
                       R_DIR / f"ref_{name}.pt")
            if name == "int8":
                del ref
                ref = r_round(torch, ops, lm, dev, name, shardmap=True)
            got = r_round(torch, ops, lm, dev, name, mesh)
            same[name] = (got["loss"] == ref["loss"] and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(full_tree(got["params"])),
                    tree_leaves(ref["params"]))))
            check(got["launches"] == ref["launches"],
                  f"path r0 ({name}): launches {got['launches']} against "
                  f"{ref['launches']}")
            print(f"path r0 ({name} exchange, (pod, data, model) = "
                  f"(1, 1, 1) on NCCL, {card}): loss {got['loss']:.6f}, "
                  f"bitwise the {'one-pod fused' if name == 'int8' else 'unpartitioned'} "
                  f"round (loss, gossiped params) = {same[name]}; launches "
                  f"{ {k: v for k, v in got['launches'].items() if v} }")
            del got, ref
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    check(all(same.values()), f"path r0: the (1, 1, 1) mesh differs: {same}")
    serve = r_serve(torch, ops, lm, dev)
    check(serve["launches"] == {k: R_LAYERS * Q_STEPS
                                if k == "decode_attention_fused" else 0
                                for k in ops.LAUNCHES},
          f"path r (unpartitioned serve): launches {serve['launches']}")
    torch.save({k: serve[k] for k in ("prefill", "decode", "tokens")},
               R_DIR / "serve.pt")
    del serve, lm
    gc.collect()
    torch.cuda.empty_cache()
    # -- the unpartitioned bf16 round, timed
    base = r_round(torch, ops, r_lm(False), dev, "bf16", timed=R_TIMED)
    base_ms, base_peak = base["ms"], base["peak"]
    check(math.isfinite(base["loss"]), "path r: unpartitioned bf16 loss")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    # -- r1: (2, 1, 2) over the host-staged backend, four ranks on the card
    n_ranks = math.prod(R_MESH)
    t0 = time.perf_counter()
    mp.spawn(r_worker, args=(n_ranks, str(R_DIR), str(dev)), nprocs=n_ranks,
             join=True)
    ranks = []
    for r in range(n_ranks):
        with open(R_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    r1_s = time.perf_counter() - t0
    for name in R_EXCHANGES:
        rows = [res["rounds"][name] for res in ranks]
        print(f"path r1 ({name} exchange, (2, 1, 2)): loss "
              f"{rows[0]['loss']:.6f}, gap to the unpartitioned round "
              f"{max(x['loss_gap'] for x in rows):.3g}; params |diff| "
              f"{max(x['err'] for x in rows):.3g} (tolerance "
              f"{rows[0]['tol']:.3g}); peak {[x['peak'] for x in rows]} B")
        check(all(x["ok"] for x in rows),
              f"path r1 ({name}) against the unpartitioned round: "
              f"{[(x['loss_gap'], x['err'], x['tol']) for x in rows]}")
    print(ranks[0]["serve_text"])
    check(ranks[0]["serve_ok"], f"path r1 prefill and decode: "
                                f"{ranks[0]['serve_text']}")
    for r, res in enumerate(ranks):
        for name in R_EXCHANGES:
            want = {k: 1 for k in R_ROUND}
            if name == "int8":
                want["dequant_neighbor_avg_rows"] = 1
            got = res["rounds"][name]["launches"]
            check(got == {k: want.get(k, 0) for k in ops.LAUNCHES},
                  f"path r1 rank {r} ({name}): launches {got}")
        check(res["serve_launches"] == {k: R_LAYERS * Q_STEPS
                                        if k in R_SERVE else 0
                                        for k in ops.LAUNCHES},
              f"path r1 rank {r} (serve): launches {res['serve_launches']}")
        check(res["imported"] == [] and res["finite_bf16"],
              f"path r1 rank {r}: imported {res['imported']}, finite bf16 "
              f"loss {res['finite_bf16']}")

    def med(ms):
        return round(statistics.median(ms[1:] if len(ms) > 1 else ms), 3)

    ms = {"unpartitioned_bf16": med(base_ms),
          "partitioned_bf16": [med(res["ms_bf16"]) for res in ranks]}
    print(f"path r (bf16 ms per round, bf16 exchange, median of "
          f"{R_TIMED} after one; {card}): unpartitioned 2 nodes "
          f"{ms['unpartitioned_bf16']} (peak {base_peak} B); (2, 1, 2) over "
          f"the host-staged backend, by rank {ms['partitioned_bf16']} "
          f"(peak {[res['peak_bf16'] for res in ranks]} B); r1 in "
          f"{r1_s:.1f} s")
    for f in R_DIR.glob("*.pt"):
        f.unlink()  # ~11 GB of references
    split = r_split_check(torch, dev, torch.Generator(device=dev)
                          .manual_seed(32))
    launches = {k: sum(res["rounds"][x]["launches"][k]
                       for res in ranks for x in R_EXCHANGES)
                + sum(res["serve_launches"][k] for res in ranks)
                for k in ops.LAUNCHES}
    print(f"path r in all {time.perf_counter() - t_r:.1f} s")
    return {"launches": launches, "split": split, "ms": ms}


# ----------------------------------------------------------------- path s
# the partitioned MoE step (ROADMAP A.14.2) at full width

S_DIR = ROOT / "build" / "path_s"     # path s's rendezvous
S_MODES = {"global": {}, "moelocal": {"moe_dispatch": "batch_local"},
           "expertpar": {"moe_dispatch": "batch_local",
                         "expert_parallel": True}}
S_LAYERS = {"mixtral-8x7b": 1, "arctic-480b": 1}  # of 32 and 35: one card
#                                                   and the time limit
S_ROUND_LAYERS = 1                    # s2's mixtral
# s2's exchanges: the fp32 one's gathered models do not fit four ranks
S_EXCHANGES = ("bf16", "int8")
S_TIMED = 3                           # bf16 train steps timed after one


def s_lm(arch, mode="global", dtype="float32", act=None, layers=None):
    """Full-width `arch` cut to S_LAYERS layers (or `layers`), in dispatch
    mode `mode`, with `dtype` params and `act` (default `dtype`)
    activations."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(dataclasses.replace(
        get_config(arch), n_layers=layers or S_LAYERS[arch],
        param_dtype=dtype, activation_dtype=act or dtype, **S_MODES[mode]))


def s_walk(tree, specs, fn, name=""):
    """fn(leaf name, leaf, its spec) over a param tree, in its order."""
    if isinstance(tree, dict):
        return {k: s_walk(v, None if specs is None else specs[k], fn, k)
                for k, v in tree.items()}
    return fn(name, tree, specs)


def s_params(torch, lm, dev, seed, mesh=None, node=False):
    """Params drawn leaf by leaf from `seed` on `dev`: norm scales 1,
    biases 0, the embedding N(0, 0.02²), a mamba2 layer's dynamics as
    `models/lm/ssm.init_ssm_layer` draws them (A_log 0, D 1, conv_b 0,
    dt_bias the inverse softplus of dt log-uniform on [1e-3, 0.1]: drawn
    N(0, 1 / fan_in) instead, dt_bias makes a random 18-layer zamba2
    amplify a 1e-7 relative change of its params ~40x more), every other
    weight N(0, 1 / fan_in) (fan_in its second-to-last dim), each drawn
    whole in its own dtype and, on `mesh`, cut at once to this rank's
    shard by the specs
    (`expert_parallel=cfg.expert_parallel`; `DTensor.from_local`: no
    collective and never a whole model on a rank).  With `node`, a node
    block [1, ...] on the pod's sub-mesh of the multi mesh
    (`node_block_specs`)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import (make_param_specs,
                                           node_block_specs, placements)
    from repro_torch.launch.mesh import pod_submesh
    from repro_torch.utils.pytree import tree_map

    meta = lm.init(torch.Generator(), device="meta")
    ep = lm.cfg.expert_parallel
    sub = specs = None
    if mesh is not None:
        sub = pod_submesh(mesh) if node else mesh
        specs = (node_block_specs(tree_map(lambda t: t[None], meta), mesh,
                                  expert_parallel=ep) if node
                 else make_param_specs(meta, mesh, expert_parallel=ep))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(name, t, spec):
        if name in ("scale", "D"):
            full = torch.ones(t.shape, dtype=t.dtype, device=dev)
        elif name in ("b", "bias", "conv_b", "A_log"):
            full = torch.zeros(t.shape, dtype=t.dtype, device=dev)
        elif name == "dt_bias":
            lo, hi = math.log(1e-3), math.log(0.1)
            dt = torch.exp(torch.rand(t.shape, generator=gen, device=dev)
                           * (hi - lo) + lo)
            full = (dt + torch.log(-torch.expm1(-dt))).to(t.dtype)
        else:
            full = torch.randn(t.shape, generator=gen, dtype=t.dtype,
                               device=dev)
            full.mul_(0.02 if name == "table"
                      else 1.0 / math.sqrt(t.shape[-2]))
        if node:
            full = full[None]
        if sub is None:
            return full
        pl = placements(spec, sub)
        local = r_shard(full, pl, sub.get_coordinate(), tuple(sub.shape))
        if local.numel() < full.numel():  # a copy: the rest is freed
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, sub, pl, shape=full.shape,
                                  stride=full.stride())

    return s_walk(meta, specs, leaf)


def s_batch(torch, lm, dev, seed, lead=(), shape=(Q_BATCH, Q_SEQ)):
    g = torch.Generator(device=dev).manual_seed(seed)
    seq = torch.randint(0, lm.cfg.vocab, lead + (shape[0], shape[1] + 1),
                        generator=g, device=dev, dtype=torch.int32)
    return {"tokens": seq[..., :-1].contiguous(),
            "labels": seq[..., 1:].contiguous()}


def s_run(torch, ops, lm, dev, mesh=None, train=True, timed=0,
          shape=(Q_BATCH, Q_SEQ), make_batch=None, window=Q_WINDOW):
    """One train step of `shape` (Q_BATCH x Q_SEQ; VT loss; with
    `train`) on a batch from `make_batch` (`s_batch`'s signature; default
    `s_batch`), prefill of the same batch, the enc-dec family's cross
    caches (`build_prep_cache_step`; kept for the checks where the mesh
    has one rank), then Q_STEPS greedy decode steps on a `window`-slot
    ring, on `mesh` or whole, each MoE layer's routing recorded
    (`moe.record_choices`); the launch counts set to 0 just before and
    read just after.  With `timed`: that many train steps more, each
    timed, and nothing else."""
    from repro_torch.dist.dfl_step import (build_prefill_step,
                                           build_prep_cache_step,
                                           build_serve_step,
                                           build_train_step)
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_batch_specs,
                                           make_cache_specs)
    from repro_torch.models.lm import moe
    from repro_torch.optim.sgd import sgd_momentum

    def place(tree, specs):
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh), mesh)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    params = s_params(torch, lm, dev, 50, mesh)
    whole = (make_batch or s_batch)(torch, lm, dev, 51, shape=shape)
    batch = place(whole, make_batch_specs)
    out = {"ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    if train:
        opt = sgd_momentum(lr=3e-3, momentum=0.9)
        state = opt.init(params)
        step = build_train_step(lm, opt, beta=LM_BETA, mesh=mesh)
        (_, _, loss), ms = clock(lambda: step(params, state, 0, batch))
        out.update(loss=float(loss), ms=[ms])
        for i in range(timed):
            out["ms"].append(clock(lambda: step(params, state, i + 1,
                                                batch))[1])
        del state
        if timed:
            out["peak"] = torch.cuda.max_memory_allocated()
            return out
    prefill = build_prefill_step(lm, mesh=mesh)
    serve = build_serve_step(lm, mesh=mesh)
    with moe.record_choices() as seen:
        logits = prefill(params, batch)
        cache = place(lm.init_cache(shape[0], window, device=dev),
                      make_cache_specs)
        if lm.prep_decode_cache is not None:
            cache = build_prep_cache_step(lm, mesh=mesh)(
                params, cache, batch["enc_embeds"])
            if mesh is None or mesh.size() == 1:
                out["cross"] = [full_tree(cache[k]).clone()
                                for k in ("cross_k", "cross_v")]
        tok = whole["tokens"][:, :1].contiguous()
        dec, toks = [], []
        for _ in range(Q_STEPS):
            lg, cache = serve(params, cache, place(tok, make_batch_specs))
            lg = full_tree(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            dec.append(lg[:, 0].float())
            toks.append(tok)
    torch.cuda.synchronize()
    out.update(launches=dict(ops.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(),
               prefill=full_tree(logits).float().cpu(),
               decode=torch.stack(dec).cpu(), tokens=torch.cat(toks, 1).cpu(),
               choices=[{k: v.cpu() for k, v in r.items()} for r in seen],
               params=params if train else None)
    return out


def s_round(torch, ops, lm, dev, name, mesh=None, shape=(Q_BATCH, Q_SEQ),
            make_batch=None):
    """One DFL round of exchange `name` over two nodes on a ring, each
    with a batch of `shape` (Q_BATCH x Q_SEQ; VT loss) from `make_batch`
    (`s_batch`'s signature; default `s_batch`): on `mesh` (the multi
    mesh)
    this rank's pod block, node p drawn from seed 40 + p and cut to the
    pod's sub-mesh at once, else both nodes stacked; the launch counts
    set to 0 just before the round and read just after."""
    from repro_torch.dist.dfl_step import build_dfl_round
    from repro_torch.dist.sharding import place_node_block
    from repro_torch.launch.mesh import pod_axis
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_map

    make_batch = make_batch or s_batch
    if mesh is None:
        nodes = [s_params(torch, lm, dev, 40 + i) for i in range(2)]
        params = tree_map(lambda *xs: torch.stack(xs), *nodes)
        del nodes
        batch = make_batch(torch, lm, dev, 41, lead=(2,), shape=shape)
    else:
        pod = pod_axis(mesh)[1]
        params = s_params(torch, lm, dev, 40 + pod, mesh, node=True)
        batch = place_node_block({k: v[pod:pod + 1].contiguous() for k, v in
                                  make_batch(torch, lm, dev, 41, (2,),
                                             shape).items()},
                                 mesh, batch=True)
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    step = build_dfl_round(lm, opt, [[0.0, 1.0], [1.0, 0.0]], beta=LM_BETA,
                           mesh=mesh, **r_exchange(torch, name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    new, state, loss = step(params, state, 0, batch)
    torch.cuda.synchronize()
    return {"launches": dict(ops.LAUNCHES), "loss": float(loss),
            "ms": 1e3 * (time.perf_counter() - t0), "params": new,
            "peak": torch.cuda.max_memory_allocated()}


def s_shards(params):
    """A rank's params as (local shard, placements) leaves, to be sent to
    the script's process (CUDA IPC) for the checks."""
    from repro_torch.utils.pytree import tree_leaves

    return [(t.to_local(), tuple(t.placements)) for t in tree_leaves(params)]


def s_worker(rank, n_ranks, out_dir, dims, jobs, results, acks):
    """One rank of path s1, t1 or u1 ((data, model) = (1, 2)) or s2, t2
    or u2 ((pod, data, model) = (2, 1, 2)) on the card (cuda:0) over the
    host-staged backend:
    runs the jobs the script's process sends (`jobs[rank]`), puts each
    result on `results` (its param shards as CUDA tensors, which the
    script compares over CUDA IPC) and frees it once `acks[rank]` says
    the checks are done; None ends it."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    # each rank keeps under its share of the card: a caching allocator
    # holding freed blocks would otherwise starve the ranks beside it
    torch.cuda.set_per_process_memory_fraction(0.94 / n_ranks, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import host_staging
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cuda", 0)
    dist.init_process_group(
        host_staging.register(), rank=rank, world_size=n_ranks,
        store=dist.FileStore(str(Path(out_dir) / f"store{n_ranks}"),
                             n_ranks))
    try:
        mesh = (make_host_mesh(data=dims[0], model=dims[1])
                if len(dims) == 2 else
                make_host_mesh(pod=dims[0], data=dims[1], model=dims[2]))
        while (job := jobs[rank].get()) is not None:
            kind = job["kind"]
            if job.get("path") == "t":
                lm, got = t_job(torch, ops, dev, mesh, job)
            elif job.get("path") == "u":
                lm, got = u_job(torch, ops, dev, mesh, job)
            elif kind == "round":
                lm = s_lm("mixtral-8x7b", "expertpar",
                          layers=S_ROUND_LAYERS)
                got = s_round(torch, ops, lm, dev, job["exchange"], mesh)
            else:
                lm = s_lm(job["arch"], job["mode"], job["dtype"],
                          job.get("act"))
                got = s_run(torch, ops, lm, dev, mesh, kind != "serve",
                            S_TIMED if kind == "timed" else 0)
            shards = (s_shards(got.pop("params"))
                      if got.get("params") is not None else None)
            got = s_host(got)  # by value through the pipe, no shared memory
            got.update(rank=rank, coord=tuple(mesh.get_coordinate()),
                       params=shards)
            gc.collect()
            torch.cuda.empty_cache()  # keep only the shards while checked
            results.put(got)
            acks[rank].get()
            del got, lm, shards
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.ipc_collect()
            results.put({"rank": rank, "freed": True})
        results.put({"rank": rank, "imported": sorted(
            k for k in sys.modules if k.split(".")[0] in ("jax", "repro"))})
    finally:
        dist.destroy_process_group()


def s_host(x):
    """A result's CPU tensors as numpy arrays (bf16 as fp32), to cross
    the queue by value; `s_torch` turns them back."""
    import torch

    if isinstance(x, dict):
        return {k: s_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [s_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return x


def s_torch(x):
    import numpy as np
    import torch

    if isinstance(x, dict):
        return {k: s_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [s_torch(v) for v in x]
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def s_param_err(torch, shards, ref, coord, sizes, dev, tol=1e-5,
                lead=None):
    """max |shard - the reference's same shard| over a rank's leaves, and
    whether it is within `tol`; `lead` cuts the reference's node dim
    first."""
    from repro_torch.utils.pytree import tree_leaves

    err, ok = 0.0, True
    for (got, pl), want in zip(shards, tree_leaves(ref)):
        if lead is not None:
            want = want[lead]
        want = r_shard(want, pl, coord, sizes).to(dev).float()
        d = (got.float() - want).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= tol).all())
        del want, d
    return err, ok


def s_choices_equal(got, want, label):
    """Each MoE layer's expert choices (and kept assignments) equal,
    compared first: a flipped near-tie moves a token by a whole expert;
    the count and probability gaps of the differing choices printed."""
    same = len(got) == len(want) > 0
    for layer, (g, w) in enumerate(zip(got, want)):
        diff = (g["experts"].sort(-1).values
                != w["experts"].sort(-1).values).any(-1)
        if bool(diff.any()):
            print(f"{label}, routed layer {layer}: {int(diff.sum())} tokens "
                  f"chose other experts, probability gaps "
                  f"{w['gap'][diff].tolist()}")
        same = same and not bool(diff.any()) and bool(
            (g["kept"] == w["kept"]).all())
    return same


def s_serve_against(torch, got, ref, label, bound, routed=True):
    """Prefill and decode logits within `bound` of the largest, equal
    tokens, equal choices (`routed`: the model has MoE layers); (ok,
    text)."""
    pre = float((got["prefill"] - ref["prefill"]).abs().max())
    pre_max = float(ref["prefill"].abs().max())
    dec = float((got["decode"] - ref["decode"]).abs().max())
    dec_max = float(ref["decode"].abs().max())
    tokens = bool(torch.equal(got["tokens"], ref["tokens"]))
    choices = (s_choices_equal(got["choices"], ref["choices"], label)
               if routed else got["choices"] == ref["choices"] == [])
    finite = bool(torch.isfinite(got["prefill"]).all()
                  and torch.isfinite(got["decode"]).all())
    ok = (pre <= bound * pre_max and dec <= bound * dec_max and tokens
          and choices and finite)
    return ok, (f"prefill |diff| {pre:.3g} of max {pre_max:.3g}, "
                f"{Q_STEPS} decode steps |diff| {dec:.3g} of max "
                f"{dec_max:.3g} (bound {bound:g} of the max), tokens equal "
                f"{tokens}" + (f", expert choices equal {choices}"
                               if routed else ""))


def s_spawn(n_ranks, dims, out_dir=S_DIR):
    """Path s's (or t's) ranks on the card, waiting for jobs: (processes,
    job queues, result queue, ack queues)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    jobs = [ctx.Queue() for _ in range(n_ranks)]
    acks = [ctx.Queue() for _ in range(n_ranks)]
    results = ctx.Queue()
    procs = mp.spawn(s_worker, args=(n_ranks, str(out_dir), dims, jobs,
                                     results, acks),
                     nprocs=n_ranks, join=False)
    return procs, jobs, results, acks


def s_get(procs, results):
    """The next result; raises if a rank failed meanwhile."""
    import queue

    while True:
        try:
            return s_torch(results.get(timeout=2))
        except queue.Empty:
            procs.join(timeout=0)  # raises on a failed rank


def s_ask(procs, jobs, results, job):
    """Send `job` to every rank; their results by rank."""
    for q in jobs:
        q.put(job)
    return sorted((s_get(procs, results) for _ in jobs),
                  key=lambda r: r["rank"])


def s_release(procs, results, acks):
    """Tell the ranks the checks are done, and wait until each has freed
    its memory on the card (the next run needs it)."""
    gc.collect()
    for q in acks:
        q.put(True)
    for _ in acks:
        check(s_get(procs, results).get("freed"), "path s: a rank's reply "
                                                  "out of order")


def s_end(procs, jobs, results):
    """End the ranks; their imports by rank."""
    for q in jobs:
        q.put(None)
    out = sorted((s_get(procs, results) for _ in jobs),
                 key=lambda r: r["rank"])
    while not procs.join():
        pass
    return [r["imported"] for r in out]


def s_kill(procs):
    """Stop the ranks of a path that failed."""
    for p in procs.processes:
        if p.is_alive():
            p.terminate()
        p.join(10)


def s_mixtral_arctic(torch, ops, dev, card, procs, jobs, results, acks,
                     add):
    """Paths s0 and s1 (the module docstring), with s1's two ranks
    waiting for jobs: for each dispatch mode the unpartitioned fp32
    mixtral run (kept on the card), the (1, 1) NCCL mesh bitwise against
    it, then the (1, 2) ranks against it; arctic's prefill and decode;
    the bf16 train step timed both ways."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import full_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves

    n_layers = S_LAYERS["mixtral-8x7b"]
    out = {"s0": {}, "s1": {}}
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(S_DIR / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh(data=1, model=1)
        for mode in S_MODES:
            t_mode = time.perf_counter()
            lm = s_lm("mixtral-8x7b", mode)
            free = torch.cuda.mem_get_info()[0]
            ref = s_run(torch, ops, lm, dev)
            want = {"vt_kl_loss_fwd": 1, "vt_kl_loss_bwd": 1,
                    "decode_attention_fused": n_layers * Q_STEPS}
            check(ref["launches"] == {k: want.get(k, 0)
                                      for k in ops.LAUNCHES},
                  f"path s ({mode}, unpartitioned): launches "
                  f"{ref['launches']}")
            got = s_run(torch, ops, lm, dev, mesh)
            add(got["launches"])
            same = {"loss": got["loss"] == ref["loss"], "params": all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(full_tree(got["params"])),
                    tree_leaves(ref["params"]))), "choices": all(
                torch.equal(g[k], w[k])
                for g, w in zip(got["choices"], ref["choices"])
                for k in ("experts", "kept")),
                **{k: bool(torch.equal(got[k], ref[k]))
                   for k in ("prefill", "decode", "tokens")}}
            print(f"path s0 ({mode}, (data, model) = (1, 1) on NCCL, "
                  f"{card}): loss {got['loss']:.6f}, bitwise the "
                  f"unpartitioned step (loss, params, prefill, {Q_STEPS} "
                  f"decode steps, tokens, expert choices) = "
                  f"{all(same.values())}; launches "
                  f"{ {k: v for k, v in got['launches'].items() if v} }; "
                  f"{free} B free on the card before it")
            check(all(same.values()), f"path s0 ({mode}): the (1, 1) mesh "
                                      f"differs: equal {same}")
            check(got["launches"] == ref["launches"],
                  f"path s0 ({mode}): launches {got['launches']}")
            out["s0"][mode] = True
            del got
            gc.collect()
            torch.cuda.empty_cache()
            # -- s1: the same steps on (1, 2), against the run kept here
            ranks = s_ask(procs, jobs, results, {
                "kind": "steps", "mode": mode, "arch": "mixtral-8x7b",
                "dtype": "float32"})
            rows = []
            for r in ranks:
                add(r["launches"])
                err, ok = s_param_err(torch, r["params"], ref["params"],
                                      r["coord"], (1, 2), dev)
                gap = abs(r["loss"] - ref["loss"])
                s_ok, text = s_serve_against(
                    torch, r, ref, f"path s1 ({mode}) rank {r['rank']}",
                    1e-3)
                want = {"vt_kl_partial_fwd": 1, "vt_kl_shard_bwd": 1,
                        **{k: n_layers * Q_STEPS for k in R_SERVE}}
                check(r["launches"] == {k: want.get(k, 0)
                                        for k in ops.LAUNCHES},
                      f"path s1 ({mode}) rank {r['rank']}: launches "
                      f"{r['launches']}")
                check(gap <= 1e-5 and ok and s_ok,
                      f"path s1 ({mode}) rank {r['rank']}: loss gap "
                      f"{gap:g}, params |diff| {err:g}; {text}")
                rows.append(dict(loss_gap=gap, params_err=err, text=text,
                                 peak=r["peak"], ms=r["ms"]))
            print(f"path s1 ({mode}, (1, 2) over the host-staged backend, "
                  f"fp32, {card}): loss gap "
                  f"{max(x['loss_gap'] for x in rows):.3g}, params |diff| "
                  f"{max(x['params_err'] for x in rows):.3g} shard for "
                  f"shard (tolerance 1e-5); {rows[0]['text']}; peak "
                  f"{[x['peak'] for x in rows]} B (whole {ref['peak']} B); "
                  f"s0 and s1 of this mode in "
                  f"{time.perf_counter() - t_mode:.1f} s")
            out["s1"][mode] = rows
            del ranks, ref, r  # the last rank's shards too (CUDA IPC)
            s_release(procs, results, acks)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # -- s1: arctic, prefill and decode (bf16 params, fp32 activations)
    for mode in ("global", "expertpar"):
        lm = s_lm("arctic-480b", mode, "bfloat16", act="float32")
        ref = s_run(torch, ops, lm, dev, train=False)
        check(ref["launches"] == {k: Q_STEPS if k == "decode_attention_fused"
                                  else 0 for k in ops.LAUNCHES},
              f"path s (arctic {mode}, unpartitioned): launches "
              f"{ref['launches']}")
        torch.cuda.empty_cache()
        ranks = s_ask(procs, jobs, results, {
            "kind": "serve", "mode": mode, "arch": "arctic-480b",
            "dtype": "bfloat16", "act": "float32"})
        texts = []
        for r in ranks:
            add(r["launches"])
            ok, text = s_serve_against(
                torch, r, ref, f"path s1 (arctic {mode}) rank {r['rank']}",
                2e-2)
            check(ok, f"path s1 (arctic {mode}) rank {r['rank']}: {text}")
            check(r["launches"] == {k: Q_STEPS if k in R_SERVE else 0
                                    for k in ops.LAUNCHES},
                  f"path s1 (arctic {mode}) rank {r['rank']}: launches "
                  f"{r['launches']}")
            texts.append(text)
        print(f"path s1 (arctic-480b {mode}, 1 layer, (1, 2), {card}): "
              f"{texts[0]}; peak {[r['peak'] for r in ranks]} B (whole "
              f"{ref['peak']} B)")
        out["s1"]["arctic_" + mode] = texts
        del ranks, ref
        s_release(procs, results, acks)
    # -- the bf16 mixtral train step, timed both ways
    base = s_run(torch, ops, s_lm("mixtral-8x7b", dtype="bfloat16"), dev,
                 timed=S_TIMED)
    check(math.isfinite(base["loss"]), "path s: bf16 loss not finite")
    torch.cuda.empty_cache()
    ranks = s_ask(procs, jobs, results, {
        "kind": "timed", "mode": "global", "arch": "mixtral-8x7b",
        "dtype": "bfloat16"})
    s_release(procs, results, acks)
    check(all(math.isfinite(r["loss"]) for r in ranks),
          "path s1: bf16 loss not finite")

    def med(ms):
        return round(statistics.median(ms[1:] if len(ms) > 1 else ms), 3)

    out["ms"] = {"unpartitioned_bf16": med(base["ms"]),
                 "partitioned_bf16": [med(r["ms"]) for r in ranks]}
    print(f"path s1 (bf16 mixtral-8x7b train step, {n_layers} layers, "
          f"4 x 128, ms, median of {S_TIMED} after one; {card}): "
          f"unpartitioned {out['ms']['unpartitioned_bf16']} (peak "
          f"{base['peak']} B), (1, 2) over the host-staged backend by rank "
          f"{out['ms']['partitioned_bf16']} (peak "
          f"{[r['peak'] for r in ranks]} B)")
    out["imported"] = s_end(procs, jobs, results)
    return out


def s_refs(torch, ops, lm, dev, exchanges=S_EXCHANGES,
           shape=(Q_BATCH, Q_SEQ), make_batch=None):
    """Path s2's (or t2's, u2's) references: each exchange's
    unpartitioned round of the two nodes, its params moved to the host
    (the int8 round alone nearly fills the card: run before s2's ranks
    hold any of it)."""
    from repro_torch.utils.pytree import tree_leaves, tree_map

    refs = {}
    for name in exchanges:
        ref = s_round(torch, ops, lm, dev, name, shape=shape,
                      make_batch=make_batch)
        want = {"vt_kl_loss_fwd": 2, "vt_kl_loss_bwd": 2,
                "decdiff_update": 1}
        check(ref["launches"] == {k: want.get(k, 0) for k in ops.LAUNCHES},
              f"path s ({name} round, unpartitioned): launches "
              f"{ref['launches']}")
        ref["grain"] = [float(max(t[i].float().abs().max() for t in
                                  tree_leaves(ref["params"]))) / 127.0
                        for i in range(2)]
        ref["params"] = tree_map(lambda t: t.cpu(), ref["params"])
        refs[name] = ref
        del ref
        torch.cuda.empty_cache()
    return refs


def s_multi(torch, ops, dev, card, refs, procs, jobs, results, acks, add,
            label="s2", job=None):
    """Path s2 (or t2 with `job` {"path": "t"}; the module docstring),
    with its four ranks waiting for jobs: each exchange's round (those of
    `refs`) on the (2, 1, 2) ranks against the unpartitioned one (`refs`,
    on the host), shard for shard (path r's tolerances: 1e-5, int8 1e-4
    plus one grain)."""
    out = {}
    for name in list(refs):
        ref = refs.pop(name)
        grain = ref["grain"]
        ranks = s_ask(procs, jobs, results, dict(job or {}, kind="round",
                                                 exchange=name))
        rows = []
        for r in ranks:
            add(r["launches"])
            pod = r["coord"][0]
            tol = 1e-4 + grain[pod] if name == "int8" else 1e-5
            err, ok = s_param_err(
                torch, r["params"], ref["params"], r["coord"][1:], (1, 2),
                dev, tol, lead=slice(pod, pod + 1))
            gap = abs(r["loss"] - ref["loss"])
            want = {"vt_kl_partial_fwd": 1, "vt_kl_shard_bwd": 1,
                    "decdiff_update": 1}
            if name == "int8":
                want["dequant_neighbor_avg_rows"] = 1
            check(r["launches"] == {k: want.get(k, 0) for k in ops.LAUNCHES},
                  f"path {label} ({name}) rank {r['rank']}: launches "
                  f"{r['launches']}")
            check(gap <= 1e-5 and ok, f"path {label} ({name}) rank "
                                      f"{r['rank']}: loss gap {gap:g}, "
                                      f"params |diff| {err:g} (tolerance "
                                      f"{tol:g})")
            rows.append(dict(loss_gap=gap, params_err=err, peak=r["peak"],
                             ms=r["ms"], tol=tol))
        print(f"path {label} ({name} exchange, (2, 1, 2), fp32, {card}): "
              f"loss {ref['loss']:.6f}, gap "
              f"{max(x['loss_gap'] for x in rows):.3g}; params |diff| "
              f"{max(x['params_err'] for x in rows):.3g} shard for shard "
              f"(tolerance {max(x['tol'] for x in rows):.3g}); ms "
              f"{[round(x['ms'], 1) for x in rows]} (unpartitioned "
              f"{ref['ms']:.1f}); peak {[x['peak'] for x in rows]} B "
              f"(unpartitioned {ref['peak']} B)")
        out[name] = rows
        del ranks, ref, r  # the last rank's shards too (CUDA IPC)
        s_release(procs, results, acks)
    return out, s_end(procs, jobs, results)


def path_s(torch, ops, dev, card):
    """The partitioned MoE step (see the module docstring): s0 the
    unpartitioned mixtral runs and the (1, 1) NCCL mesh, bitwise; s1 the
    (1, 2) mesh of two host-staged ranks sharing the card against them,
    arctic's prefill and decode, and the bf16 train step timed both ways;
    s2 the (2, 1, 2) mesh's DFL round of two nodes; then the split
    kernels at path s's shapes.  Returns the launches, the kernels'
    checks and the ms."""
    import shutil

    t_s = time.perf_counter()
    if S_DIR.exists():
        shutil.rmtree(S_DIR)
    S_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path s starts with {torch.cuda.memory_allocated()} B held by "
          f"this process, {torch.cuda.mem_get_info()[0]} B free on the "
          f"card ({card})")
    print(f"path s cuts: mixtral-8x7b {S_LAYERS['mixtral-8x7b']} of 32 "
          f"layers (the script's time limit; fp32 params, grads and "
          f"momentum of a layer ~19 GB), "
          f"arctic-480b {S_LAYERS['arctic-480b']} of 35 layers with bf16 "
          f"params and fp32 activations and no train step (one layer's "
          f"bf16 params, grads and momentum exceed 84 GB: not one card), "
          f"model = 2 on one card (the reference partitions over (16, "
          f"16)); s2's round: mixtral {S_ROUND_LAYERS} of 32 layers in "
          f"fp32 with the bf16 and int8 exchanges (four ranks on the card, "
          f"the reference on the host; the fp32 exchange's gathered models "
          f"do not fit beside)")
    launches = {k: 0 for k in ops.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    procs, jobs, results, acks = s_spawn(2, (1, 2))
    try:
        out = s_mixtral_arctic(torch, ops, dev, card, procs, jobs, results,
                               acks, add)
    except BaseException:
        s_kill(procs)
        raise
    t_s1 = time.perf_counter() - t_s
    lm = s_lm("mixtral-8x7b", "expertpar", layers=S_ROUND_LAYERS)
    refs = s_refs(torch, ops, lm, dev)
    procs, jobs, results, acks = s_spawn(4, (2, 1, 2))
    try:
        out["s2"], imported = s_multi(torch, ops, dev, card, refs, procs,
                                      jobs, results, acks, add)
    except BaseException:
        s_kill(procs)
        raise
    imported += out.pop("imported")
    check(all(i == [] for i in imported), f"path s: ranks imported "
                                          f"{imported}")
    t_s2 = time.perf_counter() - t_s - t_s1
    # -- the split kernels at path s's shapes, against their plain versions
    gen = torch.Generator(device=dev).manual_seed(33)
    vocab = lm.cfg.vocab
    y = torch.randint(0, vocab, (Q_BATCH * Q_SEQ,), generator=gen,
                      device=dev)
    out["vt"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        z = (torch.randn((Q_BATCH * Q_SEQ, vocab), generator=gen,
                         device=dev) * 3).to(dtype)
        out["vt"][str(dtype)] = q_vt_split(torch, ops, z, y, 2)
        del z
    out["da"] = {}
    sp = torch.arange(Q_WINDOW, dtype=torch.int32, device=dev)
    pos = torch.tensor(Q_WINDOW - 1, dtype=torch.int32, device=dev)
    for arch in ("mixtral-8x7b", "arctic-480b"):
        cfg = s_lm(arch).cfg
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((Q_BATCH, cfg.n_heads, cfg.head_dim),
                                     *[(Q_BATCH, Q_WINDOW, cfg.n_kv_heads,
                                        cfg.head_dim)] * 2))
            out["da"][arch, str(dtype)] = q_decode_split(
                torch, ops, q, k, v, sp, pos, 2)
            del q, k, v
    out["split"] = r_split_check(
        torch, dev, gen, lm, label="path s2's flat block (mixtral-8x7b, "
                                   "1 layer, expertpar)")
    out["launches"] = launches
    print(f"path s in all {time.perf_counter() - t_s:.1f} s (s0 + s1 "
          f"{t_s1:.1f} s, s2 {t_s2:.1f} s)")
    return out

# ----------------------------------------------------------------- path t
# the partitioned SSM and hybrid steps (ROADMAP A.14.3) at full width

T_DIR = ROOT / "build" / "path_t"     # path t's rendezvous
# of 64 and 54: zamba2's two groups of 9, mamba2 cut for the time limit
T_LAYERS = {"mamba2-2.7b": 2, "zamba2-2.7b": 18}
T_BATCH, T_SEQ = 2, 512               # two SSD chunks of 256: a carried state
T_ROUND_LAYERS = 2                    # t2's mamba2
T_EXCHANGES = ("bf16", "int8")
T_TIMED = 3                           # bf16 train steps timed after one
T_TIMED_ARCH = "mamba2-2.7b"          # the model timed (zamba2's (1, 2)
#                                       step takes ~11 s a step)


def t_lm(arch, dtype="float32", layers=None):
    """Full-width `arch` cut to T_LAYERS layers (or `layers`), with
    `dtype` params and activations."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(dataclasses.replace(
        get_config(arch), n_layers=layers or T_LAYERS[arch],
        param_dtype=dtype, activation_dtype=dtype))


def t_run(torch, ops, lm, dev, mesh=None, timed=0):
    """`s_run` of `lm` at path t's batch of T_BATCH x T_SEQ."""
    return s_run(torch, ops, lm, dev, mesh, True, timed,
                 shape=(T_BATCH, T_SEQ))


def t_job(torch, ops, dev, mesh, job):
    """A path t job on a rank (`s_worker`): (the model, its result)."""
    if job["kind"] == "round":
        lm = t_lm("mamba2-2.7b", layers=T_ROUND_LAYERS)
        return lm, s_round(torch, ops, lm, dev, job["exchange"], mesh,
                           shape=(T_BATCH, T_SEQ))
    lm = t_lm(job["arch"], job["dtype"])
    return lm, t_run(torch, ops, lm, dev, mesh,
                     T_TIMED if job["kind"] == "timed" else 0)


def lm_launches(ops, lm, split):
    """The launches of one `s_run` of `lm` (a train step, prefill, the
    enc-dec cross caches and Q_STEPS decode steps): the VT loss once each
    way, vocab-parallel on a (1, 2) mesh (`split`); the decode attention
    once an attention layer (zamba2's shared-block invocations; none in
    mamba2) and step, split-hd on (1, 2), and on (1, 2) an enc-dec
    decoder layer's cross-attention once more through the split kernels
    (whole, the plain attention)."""
    cfg = lm.cfg
    layers = (0 if cfg.family == "ssm" else
              cfg.n_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else cfg.n_layers)
    calls = layers * Q_STEPS * (2 if split and cfg.family == "encdec"
                                else 1)
    want = ({"vt_kl_partial_fwd": 1, "vt_kl_shard_bwd": 1,
             **{k: calls for k in R_SERVE}} if split else
            {"vt_kl_loss_fwd": 1, "vt_kl_loss_bwd": 1,
             "decode_attention_fused": calls})
    return {k: want.get(k, 0) for k in ops.LAUNCHES}


def mesh_steps(torch, ops, dev, card, procs, jobs, results, acks, add, p):
    """Paths t0 and t1 (or u0 and u1; the module docstring) of the path
    `p` (`T_PATH`, `U_PATH`), with its (1, 2) ranks waiting for jobs: for
    each model the unpartitioned fp32 run (kept on the card), the (1, 1)
    NCCL mesh bitwise against it, then the (1, 2) ranks against it; the
    bf16 train step of `p["timed_archs"]` timed both ways."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import full_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves

    n = p["name"]
    out = {n + "0": {}, n + "1": {}, "ms": {}}
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(p["dir"] / "store0"), 1), rank=0,
        world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh(data=1, model=1)
        for arch in p["layers"]:
            t_arch = time.perf_counter()
            lm = p["lm"](arch)
            ref = p["run"](torch, ops, lm, dev)
            check(ref["launches"] == lm_launches(ops, lm, False),
                  f"path {n} ({arch}, unpartitioned): launches "
                  f"{ref['launches']}")
            got = p["run"](torch, ops, lm, dev, mesh)
            add(got["launches"])
            same = {"loss": got["loss"] == ref["loss"], "params": all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(full_tree(got["params"])),
                    tree_leaves(ref["params"]))),
                "cross": all(torch.equal(a, b) for a, b in zip(
                    got.get("cross", []), ref.get("cross", []))),
                **{k: bool(torch.equal(got[k], ref[k]))
                   for k in ("prefill", "decode", "tokens")}}
            print(f"path {n}0 ({arch}, {lm.cfg.n_layers} layers"
                  + (f" + {lm.cfg.n_enc_layers} encoder layers"
                     if lm.cfg.n_enc_layers else "")
                  + f", (data, model) = (1, 1) on NCCL, {card}): loss "
                  f"{got['loss']:.6f}, bitwise the unpartitioned step "
                  f"(loss, params, prefill, "
                  + ("cross caches, " if "cross" in ref else "")
                  + f"{Q_STEPS} decode steps, tokens) = "
                  f"{all(same.values())}; launches "
                  f"{ {k: v for k, v in got['launches'].items() if v} }")
            check(all(same.values()), f"path {n}0 ({arch}): the (1, 1) "
                                      f"mesh differs: equal {same}")
            check(got["launches"] == ref["launches"],
                  f"path {n}0 ({arch}): launches {got['launches']}")
            out[n + "0"][arch] = True
            del got
            ref.pop("cross", None)
            gc.collect()
            torch.cuda.empty_cache()
            # -- the same steps on (1, 2), against the run kept here
            ranks = s_ask(procs, jobs, results, {
                "path": n, "kind": "steps", "arch": arch,
                "dtype": "float32"})
            rows = []
            for r in ranks:
                add(r["launches"])
                err, ok = s_param_err(torch, r["params"], ref["params"],
                                      r["coord"], (1, 2), dev)
                gap = abs(r["loss"] - ref["loss"])
                s_ok, text = s_serve_against(
                    torch, r, ref, f"path {n}1 ({arch}) rank {r['rank']}",
                    1e-3, routed=False)
                check(r["launches"] == lm_launches(ops, lm, True),
                      f"path {n}1 ({arch}) rank {r['rank']}: launches "
                      f"{r['launches']}")
                check(gap <= 1e-5 and ok and s_ok,
                      f"path {n}1 ({arch}) rank {r['rank']}: loss gap "
                      f"{gap:g}, params |diff| {err:g}; {text}")
                rows.append(dict(loss_gap=gap, params_err=err, text=text,
                                 peak=r["peak"], ms=r["ms"]))
            print(f"path {n}1 ({arch}, (1, 2) over the host-staged "
                  f"backend, fp32, {card}): loss gap "
                  f"{max(x['loss_gap'] for x in rows):.3g}, params |diff| "
                  f"{max(x['params_err'] for x in rows):.3g} shard for "
                  f"shard (tolerance 1e-5); {rows[0]['text']}; peak "
                  f"{[x['peak'] for x in rows]} B (whole {ref['peak']} B); "
                  f"{n}0 and {n}1 of this model in "
                  f"{time.perf_counter() - t_arch:.1f} s")
            out[n + "1"][arch] = rows
            del ranks, ref, r  # the last rank's shards too (CUDA IPC)
            s_release(procs, results, acks)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # -- the bf16 train steps, timed both ways

    def med(ms):
        return round(statistics.median(ms[1:] if len(ms) > 1 else ms), 3)

    for arch in p["timed_archs"]:
        base = p["run"](torch, ops, p["lm"](arch, "bfloat16"), dev,
                        timed=p["timed"])
        check(math.isfinite(base["loss"]), f"path {n} ({arch}): bf16 loss "
                                           f"not finite")
        torch.cuda.empty_cache()
        ranks = s_ask(procs, jobs, results, {
            "path": n, "kind": "timed", "arch": arch, "dtype": "bfloat16"})
        s_release(procs, results, acks)
        check(all(math.isfinite(r["loss"]) for r in ranks),
              f"path {n}1 ({arch}): bf16 loss not finite")
        out["ms"][arch] = {"unpartitioned_bf16": med(base["ms"]),
                           "partitioned_bf16": [med(r["ms"]) for r in ranks],
                           "peak": base["peak"],
                           "partitioned_peak": [r["peak"] for r in ranks]}
        print(f"path {n}1 (bf16 {arch} train step, {p['layers'][arch]} "
              f"layers, {p['batch'](arch)}, ms, median of {p['timed']} "
              f"after one; {card}): unpartitioned "
              f"{out['ms'][arch]['unpartitioned_bf16']} (peak "
              f"{base['peak']} B), (1, 2) over the host-staged backend by "
              f"rank {out['ms'][arch]['partitioned_bf16']} (peak "
              f"{out['ms'][arch]['partitioned_peak']} B)")
        del base, ranks
        torch.cuda.empty_cache()
    out["imported"] = s_end(procs, jobs, results)
    return out


T_PATH = dict(name="t", dir=T_DIR, layers=T_LAYERS, lm=t_lm, run=t_run,
              timed_archs=(T_TIMED_ARCH,), timed=T_TIMED,
              batch=lambda arch: f"{T_BATCH} x {T_SEQ}")


def path_t(torch, ops, dev, card):
    """The partitioned SSM and hybrid steps (see the module docstring): t0
    the unpartitioned mamba2 and zamba2 runs and the (1, 1) NCCL mesh,
    bitwise; t1 the (1, 2) mesh of two host-staged ranks sharing the card
    against them, and mamba2's bf16 train step timed both ways; t2 the
    (2, 1, 2) mesh's DFL round of two mamba2 nodes; then the split
    kernels at path t's shapes.  Returns the launches, the kernels' checks and the
    ms."""
    import shutil

    t_t = time.perf_counter()
    if T_DIR.exists():
        shutil.rmtree(T_DIR)
    T_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path t cuts: mamba2-2.7b {T_LAYERS['mamba2-2.7b']} of 64 "
          f"layers, zamba2-2.7b {T_LAYERS['zamba2-2.7b']} of 54 (two groups "
          f"of 9: the shared block invoked twice, two rings), fp32 for the "
          f"checks, a train step of {T_BATCH} x {T_SEQ} (two SSD chunks of "
          f"256), model = 2 on one card (the reference partitions over "
          f"(16, 16)); t2's round: mamba2 {T_ROUND_LAYERS} of 64 layers in "
          f"fp32 with the bf16 and int8 exchanges ({card})")
    launches = {k: 0 for k in ops.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    procs, jobs, results, acks = s_spawn(2, (1, 2), T_DIR)
    try:
        out = mesh_steps(torch, ops, dev, card, procs, jobs, results, acks,
                         add, T_PATH)
    except BaseException:
        s_kill(procs)
        raise
    t_t1 = time.perf_counter() - t_t
    lm = t_lm("mamba2-2.7b", layers=T_ROUND_LAYERS)
    # the ranks start up while the references run (until its first job a
    # rank holds only its CUDA context)
    procs, jobs, results, acks = s_spawn(4, (2, 1, 2), T_DIR)
    try:
        refs = s_refs(torch, ops, lm, dev, T_EXCHANGES, (T_BATCH, T_SEQ))
        out["t2"], imported = s_multi(torch, ops, dev, card, refs, procs,
                                      jobs, results, acks, add, label="t2",
                                      job={"path": "t"})
    except BaseException:
        s_kill(procs)
        raise
    imported += out.pop("imported")
    check(all(i == [] for i in imported), f"path t: ranks imported "
                                          f"{imported}")
    t_t2 = time.perf_counter() - t_t - t_t1
    # -- the split kernels at path t's shapes, against their plain versions
    gen = torch.Generator(device=dev).manual_seed(34)
    rows = T_BATCH * T_SEQ
    out["vt"] = {}
    for arch in T_LAYERS:
        vocab = t_lm(arch).cfg.vocab
        y = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            z = (torch.randn((rows, vocab), generator=gen, device=dev)
                 * 3).to(dtype)
            out["vt"][arch, str(dtype)] = q_vt_split(torch, ops, z, y, 2)
            del z
    out["da"] = {}
    cfg = t_lm("zamba2-2.7b").cfg
    sp = torch.arange(Q_WINDOW, dtype=torch.int32, device=dev)
    pos = torch.tensor(Q_WINDOW - 1, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((T_BATCH, cfg.n_heads, cfg.head_dim),
                                 *[(T_BATCH, Q_WINDOW, cfg.n_kv_heads,
                                    cfg.head_dim)] * 2))
        out["da"][str(dtype)] = q_decode_split(torch, ops, q, k, v, sp, pos,
                                               2, row=T_BATCH - 1)
        del q, k, v
    out["split"] = r_split_check(
        torch, dev, gen, lm, label=f"path t2's flat block (mamba2-2.7b, "
                                   f"{T_ROUND_LAYERS} layers)")
    out["launches"] = launches
    out["s"] = round(time.perf_counter() - t_t, 1)
    print(f"path t in all {out['s']:.1f} s (t0 + t1 {t_t1:.1f} s, t2 "
          f"{t_t2:.1f} s)")
    return out


# ----------------------------------------------------------------- path u
# the partitioned enc-dec and VLM steps (ROADMAP A.14.4) at full width

U_DIR = ROOT / "build" / "path_u"     # path u's rendezvous
# of 32 + 32 (whisper: encoder + decoder; 4 + 4 until the whole script's
# time limit) and 32 (llava): the time limit
U_LAYERS = {"whisper-large-v3": 2, "llava-next-mistral-7b": 2}
# whisper: 448 decoder tokens after a 30 s window's 1500 frames; llava:
# 128 text tokens after its 2880 anyres image tokens
U_SHAPE = {"whisper-large-v3": (2, 448), "llava-next-mistral-7b": (2, 128)}
U_ENC_LEN = 1500
U_WINDOW = {"whisper-large-v3": 448, "llava-next-mistral-7b": Q_WINDOW}
U_ROUND_LAYERS = 2                    # u2's whisper, encoder and decoder
U_EXCHANGES = ("bf16", "int8")
U_TIMED = 3                           # bf16 train steps timed after one
U_TIMED_ARCHS = ("whisper-large-v3",)  # the model timed (llava's (1, 2)
#                                       step takes ~3.2 s a step)


def u_lm(arch, dtype="float32", layers=None):
    """Full-width `arch` cut to U_LAYERS layers (or `layers`; whisper's
    encoder as its decoder), with `dtype` params and activations."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    cfg = get_config(arch)
    n = layers or U_LAYERS[arch]
    return build_lm(dataclasses.replace(
        cfg, n_layers=n, n_enc_layers=n if cfg.n_enc_layers else 0,
        param_dtype=dtype, activation_dtype=dtype))


def u_batch(torch, lm, dev, seed, lead=(), shape=None):
    """`s_batch` at the model's U_SHAPE (or `shape`), with whisper's
    U_ENC_LEN encoder frames or llava's image embeddings, N(0, 1) in the
    activation dtype."""
    cfg = lm.cfg
    shape = shape or U_SHAPE[cfg.arch_id]
    out = s_batch(torch, lm, dev, seed, lead, shape)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    key, n = (("enc_embeds", U_ENC_LEN) if cfg.family == "encdec"
              else ("img_embeds", cfg.img_tokens))
    out[key] = torch.randn(lead + (shape[0], n, cfg.d_model), generator=g,
                           device=dev).to(cfg.adtype)
    return out


def u_run(torch, ops, lm, dev, mesh=None, timed=0):
    """`s_run` of `lm` at its U_SHAPE batch (`u_batch`) and U_WINDOW
    ring."""
    arch = lm.cfg.arch_id
    return s_run(torch, ops, lm, dev, mesh, True, timed,
                 shape=U_SHAPE[arch], make_batch=u_batch,
                 window=U_WINDOW[arch])


def u_job(torch, ops, dev, mesh, job):
    """A path u job on a rank (`s_worker`): (the model, its result)."""
    if job["kind"] == "round":
        lm = u_lm("whisper-large-v3", layers=U_ROUND_LAYERS)
        return lm, s_round(torch, ops, lm, dev, job["exchange"], mesh,
                           shape=U_SHAPE["whisper-large-v3"],
                           make_batch=u_batch)
    lm = u_lm(job["arch"], job["dtype"])
    return lm, u_run(torch, ops, lm, dev, mesh,
                     U_TIMED if job["kind"] == "timed" else 0)


U_PATH = dict(name="u", dir=U_DIR, layers=U_LAYERS, lm=u_lm, run=u_run,
              timed_archs=U_TIMED_ARCHS, timed=U_TIMED,
              batch=lambda arch: " x ".join(map(str, U_SHAPE[arch])))


def path_u(torch, ops, dev, card):
    """The partitioned enc-dec and VLM steps (see the module docstring):
    u0 the unpartitioned whisper and llava runs and the (1, 1) NCCL mesh,
    bitwise; u1 the (1, 2) mesh of two host-staged ranks sharing the card
    against them, and whisper's bf16 train step timed both ways; u2 the
    (2, 1, 2) mesh's DFL round of two whisper nodes; then the split
    kernels at path u's shapes.  Returns the launches, the kernels'
    checks and the ms."""
    import shutil

    t_u = time.perf_counter()
    if U_DIR.exists():
        shutil.rmtree(U_DIR)
    U_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    wl, ll = U_LAYERS["whisper-large-v3"], U_LAYERS["llava-next-mistral-7b"]
    print(f"path u cuts: whisper-large-v3 {wl} + {wl} of 32 + 32 layers "
          f"(encoder + decoder), llava-next-mistral-7b {ll} of 32 (the "
          f"script's time limit), fp32 for the checks; whisper's batch 2 x "
          f"448 decoder tokens after {U_ENC_LEN} frames, llava's 2 x 128 "
          f"text tokens after 2880 image tokens; model = 2 on one card (the "
          f"reference partitions over (16, 16)); u2's round: whisper "
          f"{U_ROUND_LAYERS} + {U_ROUND_LAYERS} layers in fp32 with the bf16 "
          f"and int8 exchanges ({card})")
    launches = {k: 0 for k in ops.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    procs, jobs, results, acks = s_spawn(2, (1, 2), U_DIR)
    try:
        out = mesh_steps(torch, ops, dev, card, procs, jobs, results, acks,
                         add, U_PATH)
    except BaseException:
        s_kill(procs)
        raise
    t_u1 = time.perf_counter() - t_u
    lm = u_lm("whisper-large-v3", layers=U_ROUND_LAYERS)
    procs, jobs, results, acks = s_spawn(4, (2, 1, 2), U_DIR)
    try:
        refs = s_refs(torch, ops, lm, dev, U_EXCHANGES,
                      U_SHAPE["whisper-large-v3"], make_batch=u_batch)
        out["u2"], imported = s_multi(torch, ops, dev, card, refs, procs,
                                      jobs, results, acks, add, label="u2",
                                      job={"path": "u"})
    except BaseException:
        s_kill(procs)
        raise
    imported += out.pop("imported")
    check(all(i == [] for i in imported), f"path u: ranks imported "
                                          f"{imported}")
    t_u2 = time.perf_counter() - t_u - t_u1
    # -- the split kernels at path u's shapes, against their plain versions
    gen = torch.Generator(device=dev).manual_seed(35)
    out["vt"] = {}
    for arch in U_LAYERS:
        vocab, rows = u_lm(arch).cfg.vocab, math.prod(U_SHAPE[arch])
        y = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            z = (torch.randn((rows, vocab), generator=gen, device=dev)
                 * 3).to(dtype)
            out["vt"][arch, str(dtype)] = q_vt_split(torch, ops, z, y, 2)
            if (vocab // 2) % 2:  # an odd shard: every row phase
                q_vt_bitwise(torch, ops, z[:, vocab // 2:].contiguous(), y,
                             vocab, vocab // 2)
            del z
    out["da"] = {}
    for label, arch, w in (("whisper ring", "whisper-large-v3", 448),
                           ("whisper cross", "whisper-large-v3", U_ENC_LEN),
                           ("llava ring", "llava-next-mistral-7b", Q_WINDOW)):
        cfg = u_lm(arch).cfg
        b = U_SHAPE[arch][0]
        sp = torch.arange(w, dtype=torch.int32, device=dev)
        pos = torch.tensor(w - 1, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, cfg.n_heads, cfg.head_dim),
                                     *[(b, w, cfg.n_kv_heads,
                                        cfg.head_dim)] * 2))
            out["da"][label, str(dtype)] = q_decode_split(
                torch, ops, q, k, v, sp, pos, 2, row=b - 1)
            del q, k, v
    out["split"] = r_split_check(
        torch, dev, gen, lm, label=f"path u2's flat block (whisper-large-v3, "
                                   f"{U_ROUND_LAYERS} + {U_ROUND_LAYERS} "
                                   f"layers)")
    out["launches"] = launches
    out["s"] = round(time.perf_counter() - t_u, 1)
    print(f"path u in all {out['s']:.1f} s (u0 + u1 {t_u1:.1f} s, u2 "
          f"{t_u2:.1f} s)")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.comm import CommConfig, EdgeGossipTransport
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.graphs.topology import barabasi_albert
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gather_rows import gather_rows_plain
    from repro_torch.kernels.segment_avg import segment_avg_plain
    from repro_torch.utils.pytree import tree_flatten_stacked, tree_leaves

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # -- build every kernel of the port, all nvcc processes at once ------
    t0 = time.perf_counter()
    libs = _build.build(sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")))
    check(sorted(libs) == ["decdiff_update", "decode_attention",
                           "decode_attention_split",
                           "dequant_avg", "dequant_avg_rows",
                           "dequant_segment_avg", "gather_rows",
                           "neighbor_avg", "segment_avg", "vt_kl_loss"],
          f"kernel sources {sorted(libs)}")
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_DIR})")
    if "--path-n" in sys.argv[1:]:  # path n alone, for its development
        run_path_n(torch, ops, dev, card, "--profile" in sys.argv[1:])
        print(f"chip_smoke --path-n finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-o" in sys.argv[1:]:  # path o alone, for its development
        path_o(torch, ops, dev, card)
        print(f"chip_smoke --path-o finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-p" in sys.argv[1:]:  # path p alone, for its development
        path_p(torch, ops, dev, card)
        print(f"chip_smoke --path-p finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-q" in sys.argv[1:]:  # path q alone, for its development
        path_q(torch, ops, dev, card)
        print(f"chip_smoke --path-q finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-r" in sys.argv[1:]:  # path r alone, for its development
        path_r(torch, ops, dev, card)
        print(f"chip_smoke --path-r finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-s" in sys.argv[1:]:  # path s alone, for its development
        path_s(torch, ops, dev, card)
        print(f"chip_smoke --path-s finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-t" in sys.argv[1:]:  # path t alone, for its development
        path_t(torch, ops, dev, card)
        print(f"chip_smoke --path-t finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-u" in sys.argv[1:]:  # path u alone, for its development
        path_u(torch, ops, dev, card)
        print(f"chip_smoke --path-u finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--vt-split" in sys.argv[1:]:  # B.3's split kernels alone
        vt_split_shapes(torch, ops, dev)
        print(f"chip_smoke --vt-split finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--path-q-decode" in sys.argv[1:]:  # B.9's split kernels alone
        q_decode_shapes(torch, ops, dev,
                        torch.Generator(device=dev).manual_seed(28))
        print(f"chip_smoke --path-q-decode finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0

    # -- the world of every full-width path --------------------------------
    t0 = time.perf_counter()
    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2, scale=1.0)
    sched = Schedule(rounds=ROUNDS, eval_every=1)
    exp = Experiment(world, "decdiff+vt", schedule=sched)
    n_params = tree_flatten_stacked(exp.params)[0].shape[1]
    n_dir = int(world.topo.neighbor_mask.sum())
    print(f"world + experiment built in {time.perf_counter() - t0:.1f} s: "
          f"{exp.n} nodes, {n_params} params per node, "
          f"{len(world.x_test)} test images, degrees "
          f"{world.topo.degrees.tolist()}, max degree "
          f"{world.topo.max_degree}, {n_dir} directed edges")
    check(n_params == 567434, f"MLP has {n_params} params, not 567434")
    # the reduce's inputs at the main path's shape, before any round
    table0 = tree_flatten_stacked(exp.params)[0]
    vals_main = table0[exp.nbr_idx].contiguous()
    w_main = (exp.nbr_weight * exp.nbr_valid).contiguous()

    # -- path a: no transport ----------------------------------------------
    hist_a, l_plain, ms_plain, _, _ = drive(torch, ops, exp,
                                            "path a (no transport)")
    snaps = {"a": snapshot(torch, exp, hist_a)}
    check(l_plain["segment_neighbor_avg"] >= ROUNDS,
          f"segment_neighbor_avg launched {l_plain} in {ROUNDS} rounds")
    vt_per_path = ROUNDS * exp.train.steps_per_round  # one per local step
    check(l_plain["vt_kl_loss_fwd"] == l_plain["vt_kl_loss_bwd"]
          == vt_per_path, f"path a: vt_kl_loss launches {l_plain}")
    check(l_plain["decdiff_update"] == ROUNDS,
          f"path a: decdiff_update launches {l_plain}")

    # -- path b: the per-edge transport ------------------------------------
    exp_e = Experiment(world, "decdiff+vt", schedule=sched,
                       comm=CommConfig(codec="int8", policy="adaptive",
                                       target_trigger=0.95))
    payload = exp_e.transport.payload_bytes
    check(payload == n_params + 4, f"int8 payload {payload} bytes")
    hist_e, l_edge, ms_edge, bytes_e, trig_e = drive(
        torch, ops, exp_e, "path b (per-edge int8 adaptive 0.95)")
    snaps["b"] = snapshot(torch, exp_e, hist_e)
    check(l_edge["gather_rows"] == ROUNDS,
          f"gather_rows launched {l_edge['gather_rows']} times in {ROUNDS} "
          f"rounds")
    check(l_edge["segment_neighbor_avg"] >= ROUNDS,
          f"segment_neighbor_avg launched {l_edge} in {ROUNDS} rounds")
    check(l_edge["vt_kl_loss_fwd"] == l_edge["vt_kl_loss_bwd"]
          == vt_per_path, f"path b: vt_kl_loss launches {l_edge}")
    check(l_edge["decdiff_update"] == l_edge["drift_norms"] == ROUNDS,
          f"path b: decdiff_update / drift_norms launches {l_edge}")
    sent_e = [t * n_dir for t in trig_e]
    check(len(sent_e) == ROUNDS and all(abs(x - round(x)) < 1e-3
                                        for x in sent_e),
          f"fired edges per round {sent_e}")
    fired = sum(round(x) for x in sent_e)
    print(f"path b: fired edges per round {[round(x) for x in sent_e]}, "
          f"bytes on the wire {bytes_e:.0f} = {payload} x {fired}")
    check(bytes_e == payload * fired and bytes_e <= n_dir * payload * ROUNDS,
          f"per-edge bytes {bytes_e} != {payload} x {fired}")
    check(all(0.0 < m.triggered_frac <= 1.0 for m in hist_e),
          f"triggered fractions {[m.triggered_frac for m in hist_e]}")

    # -- path c: the per-node transport, always send -----------------------
    exp_n = Experiment(world, "decdiff+vt", schedule=sched,
                       comm=CommConfig(codec="int8"))
    hist_n, l_node, ms_node, bytes_n, trig_n = drive(
        torch, ops, exp_n, "path c (per-node int8, always send)")
    snaps["c"] = snapshot(torch, exp_n, hist_n)
    check(l_node["segment_neighbor_avg"] >= ROUNDS and
          l_node["gather_rows"] == 0 and
          l_node["vt_kl_loss_fwd"] == l_node["vt_kl_loss_bwd"]
          == vt_per_path and l_node["decdiff_update"] == ROUNDS
          and l_node["drift_norms"] == ROUNDS,
          f"per-node launches {l_node}")
    # threshold 0: every gate fires, Σ_i gate_i·outdeg_i = directed edges
    check(trig_n == [1.0] * ROUNDS and bytes_n == payload * n_dir * ROUNDS,
          f"per-node bytes {bytes_n} != {payload} x {n_dir} x {ROUNDS} "
          f"(triggered {trig_n})")
    check(all(m.triggered_frac == 1.0 for m in hist_n), "per-node trigger")

    # -- path f: the FedAvg server (the paper's FED baseline) -------------
    exp_f = Experiment(world, "fedavg", schedule=sched)
    hist_f, l_fed, ms_fed, _, _ = drive(torch, ops, exp_f,
                                        "path f (fedavg, server average)")
    check(l_fed["neighbor_avg"] == ROUNDS
          and l_fed["segment_neighbor_avg"] == 0,
          f"path f: launches {l_fed}")

    def one_model(e, m):
        """Every node's params bitwise equal, and so its 16 accuracies."""
        return all(bool((t == t[:1]).all()) for t in tree_leaves(e.params)) \
            and bool((m.acc_per_node == m.acc_per_node[0]).all())

    check(one_model(exp_f, hist_f[-1]) and all(
        (m.acc_per_node == m.acc_per_node[0]).all() for m in hist_f),
        "path f: the nodes' models or accuracies differ")
    for _ in range(ROUNDS):  # and after each round, one round at a time
        m = exp_f.run(rounds=1, eval_every=1)[0]
        check(one_model(exp_f, m), "path f: the nodes' models differ after "
                                   "a round")
    print(f"path f: every node's params bitwise equal after each round; "
          f"accuracy {hist_f[-1].acc_per_node[0]:.4f} on every node")

    # -- path g: CFA-GE, Eq. 9 then the gradient exchange ---------------
    exp_g = Experiment(world, "cfa-ge", schedule=sched)
    hist_g, l_ge, ms_ge, _, _ = drive(torch, ops, exp_g,
                                      "path g (cfa-ge, gradient exchange)")
    snaps["g"] = snapshot(torch, exp_g, hist_g)
    check(l_ge["segment_neighbor_avg"] == ROUNDS and l_ge["neighbor_avg"] == 0,
          f"path g: launches {l_ge}")
    print(f"ms per round: no transport {ms_plain:.2f}, per-edge "
          f"{ms_edge:.2f}, per-node {ms_node:.2f}, fedavg {ms_fed:.2f}, "
          f"cfa-ge {ms_ge:.2f}")
    # the host's load moves a round's wall time from call to call: compare
    # the paths in turns (a, b, c, f, g, g, f, c, b, a) within this call
    turns = {"a": [], "b": [], "c": [], "f": [], "g": []}
    for key in "abcfggfcba":
        e = {"a": exp, "b": exp_e, "c": exp_n, "f": exp_f, "g": exp_g}[key]
        t0 = time.perf_counter()
        e.run(rounds=ROUNDS, eval_every=1)
        torch.cuda.synchronize()
        turns[key].append(1e3 * (time.perf_counter() - t0) / ROUNDS)
    print("ms per round in turns a, b, c, f, g, g, f, c, b, a: " + ", ".join(
        f"{k} {statistics.median(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})"
        for k, v in turns.items()))

    # -- the small world, card vs cpu ----------------------------------------
    small_world_agrees(torch, dev)
    small_world_agrees(torch, dev, CommConfig(
        codec="int8", policy="adaptive", target_trigger=0.95,
        stochastic=False), "per-edge int8 adaptive 0.95, deterministic")
    small_world_agrees(torch, dev, method="fedavg")
    small_world_agrees(torch, dev, method="cfa-ge")
    small_world_agrees(torch, dev, label="no transport", layout="sparse")

    # -- paths a, b, c and g again on the sparse layout: bitwise equal ------
    vt_checks = dict(vt_kl_loss_fwd=vt_per_path, vt_kl_loss_bwd=vt_per_path,
                     decdiff_update=ROUNDS, drift_norms=0)
    comm_checks = dict(vt_checks, drift_norms=ROUNDS)
    sparse_launches = {}
    for key, label, method, comm, want in [
            ("a", "path a", "decdiff+vt", None, vt_checks),
            ("b", "path b", "decdiff+vt",
             CommConfig(codec="int8", policy="adaptive", target_trigger=0.95),
             comm_checks),
            ("c", "path c", "decdiff+vt", CommConfig(codec="int8"),
             comm_checks),
            ("g", "path g", "cfa-ge", None, dict(neighbor_avg=0))]:
        sparse_launches[f"{key}_s"], _ = sparse_equals_dense(
            torch, ops, world, snaps[key], label, method, comm, sched, want)

    # -- path k: time-varying graphs and the event clock at full width ---
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    lmk = path_k(torch, ops, dev, world, snaps["a"], profile)
    k_s = time.perf_counter() - t0
    print(f"path k took {k_s:.1f} s")
    # -- path l: telemetry on the same world (l3 and l4 run in h and i) ---
    t0 = time.perf_counter()
    lml = path_l(torch, ops, dev, world)
    l_s = time.perf_counter() - t0
    print(f"path l (l0-l2 and profile_dir) took {l_s:.1f} s")
    # -- path m: the pod backend (m2 is held to path d after path d) -----
    t0 = time.perf_counter()
    lmm = path_m(torch, ops, dev, world, ms_plain)
    m_s = time.perf_counter() - t0
    print(f"path m (m0-m2) took {m_s:.1f} s")
    del snaps
    # CFA-GE's gradient walk cut into calls of 16 edges (the last one holds
    # the rest): both layouts make the same calls, so they stay bitwise equal
    from repro_torch.engine import backends

    ge_chunk, backends.GE_CHUNK = backends.GE_CHUNK, 16
    try:
        exp_g16 = Experiment(world, "cfa-ge", schedule=sched)
        hist_g16, sparse_launches["g16"], _, _, _ = drive(
            torch, ops, exp_g16, "path g, gradient walk in calls of 16 edges")
        print(f"path g (calls of 16 edges): {ge_walk_rows(exp_g16)}")
        snap_g16 = snapshot(torch, exp_g16, hist_g16)
        del exp_g16, hist_g16
        gc.collect()
        sparse_launches["g16_s"], _ = sparse_equals_dense(
            torch, ops, world, snap_g16, "path g (calls of 16 edges)",
            "cfa-ge", None, sched, dict(neighbor_avg=0))
        del snap_g16
    finally:
        backends.GE_CHUNK = ge_chunk

    # -- B.5 at path c's per-node shape: the round's int8 payloads ---------
    from repro_torch.comm.codecs import Int8Codec

    pay_c, _ = Int8Codec(stochastic=False).encode(
        tree_flatten_stacked(exp_n.params)[0])
    dqs_main = dqseg_vs_plain(
        torch, ops, pay_c["q"][exp_n.nbr_idx],
        pay_c["scale"][exp_n.nbr_idx].contiguous(),
        (exp_n.nbr_weight * exp_n.nbr_valid).contiguous(),
        "path c (real int8 payloads of the 16 nodes, per-node panel)",
        cold=True)
    del pay_c

    # -- each kernel against its plain version, at the main path's shapes
    seg = kernel_vs_plain(torch, ops, segment_avg_plain, vals_main, w_main,
                          "main path (16-node BA m=2, real weights)",
                          cold=True)
    # path m1's blocks: pod 0's 8 receivers of the 16
    blk = exp.n // M_PODS
    seg_m = kernel_vs_plain(torch, ops, segment_avg_plain,
                            vals_main[:blk].contiguous(),
                            w_main[:blk].contiguous(),
                            f"path m1's per-pod panel (pod 0, {blk} of "
                            f"{exp.n} receivers)", cold=True)
    sums_m, tot_m = ops.segment_neighbor_avg(vals_main[:blk].contiguous(),
                                             w_main[:blk].contiguous())
    eq5_m = eq5_vs_plain(torch, table0[:blk].contiguous(),
                         (sums_m / tot_m[:, None]).contiguous(),
                         tot_m.contiguous(),
                         f"path m1's block [{blk}, {n_params}] and its "
                         f"neighbourhood average")
    del sums_m, tot_m
    table_e = exp_e.comm_state.last_sent.reshape(-1, n_params)
    gat = gather_vs_plain(torch, ops, gather_rows_plain, table_e,
                          exp_e.transport.flat_idx,
                          "per-edge path (real per-link table after "
                          f"{ROUNDS + 1} rounds)", cold=True)
    gat_m = gather_vs_plain(
        torch, ops, gather_rows_plain, table_e,
        exp_e.transport.flat_idx[:blk * exp_e.transport.e].contiguous(),
        f"path m1's per-pod receivers ({blk} of {exp.n} rows of the "
        f"replicated per-link table)", cold=True)
    # the trigger's drift: path b's per-edge rows (each node's model
    # against its per-link references), path m1's pod block of them, and
    # path c's per-node rows
    n_e = exp_e.transport.e
    x_e = tree_flatten_stacked(exp_e.params)[0][:, None, :].expand(
        exp.n, n_e, n_params).reshape(-1, n_params).contiguous()
    drift = drift_vs_plain(torch, x_e, table_e,
                           "path b (real per-edge rows after "
                           f"{ROUNDS + 1} rounds)")
    drift_m = drift_vs_plain(torch, x_e[:blk * n_e], table_e[:blk * n_e],
                             f"path m1's block ({blk} of {exp.n} senders' "
                             f"per-edge rows)")
    del x_e
    drift_c = drift_vs_plain(
        torch, tree_flatten_stacked(exp_n.params)[0],
        exp_n.comm_state.last_sent.to(torch.float32).contiguous(),
        "path c (real per-node rows)")
    del vals_main, table_e
    topo64 = barabasi_albert(64, m=2, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    k64 = topo64.max_degree
    vals64 = torch.randn((64, k64, n_params), generator=gen, device=dev)
    w64 = torch.from_numpy(topo64.neighbor_mask.astype("float32")).to(dev) \
        * torch.rand((64, k64), generator=gen, device=dev)
    kernel_vs_plain(torch, ops, segment_avg_plain, vals64, w64.contiguous(),
                    "64-node BA m=2")
    del vals64
    tr64 = EdgeGossipTransport(CommConfig(per_edge=True),
                               {"w": torch.zeros((64, 1), device=dev)},
                               topo64.neighbor_idx, topo64.neighbor_mask)
    tbl64 = torch.randn((64 * k64, n_params), generator=gen, device=dev)
    gather_vs_plain(torch, ops, gather_rows_plain, tbl64, tr64.flat_idx,
                    "64-node BA m=2, random rows")
    del tbl64
    nav_f = navg_vs_plain(torch, ops, tree_flatten_stacked(exp_f.params)[0],
                          exp_f.agg_state["counts"],
                          "path f (real stack after the last round, |D_i| "
                          "weights)", cold=True)
    if profile:
        profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                      "no-transport (eval included)")
        profile_round(torch, lambda: exp_e.run(rounds=1, eval_every=1),
                      "per-edge transport (eval included)")
        profile_round(torch, lambda: exp_g.run(rounds=1, eval_every=1),
                      "path g cfa-ge (eval included)")
    exp_beta = exp.train.beta
    # an Experiment's round closure refers back to it, so only the cycle
    # collector frees the MLP paths' data and models before path d
    del exp, exp_e, exp_n, exp_f, exp_g, e, world, table0
    gc.collect()

    # -- path h: the sparse layout at full MLP width; path i: 10^4 nodes ---
    lmh = path_h(torch, ops, dev, profile)
    lmi = path_i(torch, ops, dev, profile)
    torch.cuda.empty_cache()

    # -- path j: the paper's Table II / IV path at the CNN's full width ----
    lmj = path_j(torch, ops, dev, profile)
    small_world_agrees(torch, dev, cnn=True)
    small_world_agrees(torch, dev, method="fedavg", cnn=True)
    cnn_oracles(torch, dev)
    torch.cuda.empty_cache()

    # -- path d: the LM DFL pod round at full width ------------------------
    lmd = path_d(torch, ops, dev, profile)
    small_lm_agrees(torch, dev)
    dq = dequant_vs_plain(torch, ops, lmd["q"], lmd["scale"], lmd["wn"],
                          "path d (real int8 payload of the 4 nodes)")
    lm_blk = LM_NODES // M_PODS
    dq_m = dequant_vs_plain(torch, ops, lmd["q"], lmd["scale"],
                            lmd["wn"][:lm_blk].contiguous(),
                            f"path m2's pod block (real int8 payload of the "
                            f"{LM_NODES} nodes, {lm_blk} receivers)")
    # -- path m2 against path d: the same init, batches and rounds -------
    m2 = lmm["m2"]
    loss_gap = max(abs(a - b) for a, b in zip(m2["losses"], lmd["losses"]))
    print(f"path m2 against path d after {1 + M2_ROUNDS} rounds: node "
          f"digests equal = {m2['digests'] == lmd['digests']}, loss gap "
          f"{loss_gap}; ms per round {m2['ms']} against path d's "
          f"{lmd['ms']}")
    check(m2["digests"] == lmd["digests"],
          "path m2's params differ from the one-pod round's (path d)")
    check(loss_gap <= 1e-5 * max(1.0, max(abs(x) for x in lmd["losses"])),
          f"path m2's losses {m2['losses']} against {lmd['losses']}")
    # the int8 route of path d's gossip, one receiver at a time, through
    # the reference's entry point `dequant_neighbor_avg`
    ops.reset_launches()
    for r in range(LM_NODES):
        avg_r = ops.dequant_neighbor_avg(lmd["q"], lmd["scale"],
                                         lmd["wn"][r].contiguous())
        del avg_r
    torch.cuda.synchronize()
    l_dq1 = dict(ops.LAUNCHES)
    print(f"path d int8 route, one receiver at a time "
          f"(dequant_neighbor_avg x {LM_NODES}): kernel launches {l_dq1}")
    check(l_dq1["dequant_neighbor_avg"] == LM_NODES,
          f"dequant_neighbor_avg launched {l_dq1} times for {LM_NODES} "
          f"receivers")
    dqa_main = dqavg_vs_plain(torch, ops, lmd["q"], lmd["scale"],
                              lmd["wn"][0].contiguous(),
                              "path d (real int8 block, receiver 0's ring "
                              "weights)")
    nav_lm = navg_vs_plain(torch, ops, lmd["w"], lmd["wn"][0],
                           "path d's flat block, receiver 0's ring weights")
    avg = ops.dequant_neighbor_avg_rows(lmd.pop("q"), lmd["scale"], lmd["wn"])
    eq5 = eq5_vs_plain(torch, lmd.pop("w"), avg, lmd["row"],
                       "path d (real flat block and its average)")
    del avg
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(1)
    q8 = torch.randint(-127, 128, (8, 1_000_003), generator=gen, device=dev,
                       dtype=torch.int8)
    wn8 = torch.rand((8, 8), generator=gen, device=dev)
    wn8.fill_diagonal_(0.0)
    wn8[3] = 0.0
    wn8 = (wn8 / torch.clamp(wn8.sum(1, keepdim=True), min=1e-30)
           ).contiguous()
    dequant_vs_plain(torch, ops, q8, torch.rand(8, generator=gen,
                                                device=dev) * 0.05, wn8,
                     "odd D, 8 receivers, one zero row")
    del q8
    x10 = torch.randn((10, 1_000_003), generator=gen, device=dev)
    w10 = torch.rand(10, generator=gen, device=dev)
    w10[4] = 0.0
    nav_odd = navg_vs_plain(torch, ops, x10, w10,
                            "odd N = 10, odd D, one zero weight")
    del x10
    vt_main = vt_vs_plain(torch, ops, lmd["logits"], lmd["labels"],
                          "path d (node 0's real logits)")
    vt_vs_plain(torch, ops, lmd["logits"].float(), lmd["labels"],
                "path d logits in fp32")
    # the MLP's [N·B, 10], path m1's block [R·B, 10], one node's batch
    vt_mlp = {}
    for b in (16 * 32, 8 * 32, 32):
        z = torch.randn((b, 10), generator=gen, device=dev) * 3
        y = torch.randint(0, 10, (b,), generator=gen, device=dev)
        y[0], y[-1] = 0, 9
        vt_mlp[b] = vt_vs_plain(torch, ops, z, y, f"MLP classes [{b}, 10]",
                                beta=exp_beta)

    # -- path e: dense serving at full width, after path d's state is gone
    torch.cuda.empty_cache()
    lme = path_e(torch, ops, dev, profile)
    small_serve_agrees(torch, dev)
    da_main = decode_vs_plain(torch, ops, lme.pop("q"), lme.pop("k"),
                              lme.pop("v"), lme.pop("sp"), lme.pop("pos"),
                              "path e (real layer-0 cache, real query)")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    da_shapes = []
    f32, bf16 = torch.float32, torch.bfloat16
    for label, (b, h, w, kk, hd), q_dtype, filled, window in [
            ("full synthetic window", (8, 16, SERVE_WINDOW, 16, 64), f32,
             SERVE_WINDOW, 0),
            ("qwen2.5-14b GQA", (8, 40, SERVE_WINDOW, 8, 128), f32,
             SERVE_WINDOW, 0),
            ("qwen2.5-14b GQA, bf16 q", (8, 40, SERVE_WINDOW, 8, 128), bf16,
             SERVE_WINDOW, 0),
            ("qwen3-32b G = 8, hd 128", (8, 64, SERVE_WINDOW, 8, 128), bf16,
             SERVE_WINDOW, 0),
            ("odd B and W, sliding window 700", (3, 16, 1000, 16, 64), f32,
             997, 700),
            ("W below one tile", (3, 16, 40, 16, 64), bf16, 40, 0),
            ("W one slot past a tile", (2, 16, 4097, 16, 64), bf16, 4097, 0),
            ("all-masked ring", (2, 16, 1000, 16, 64), bf16, 0, 0)]:
        q = torch.randn((b, h, hd), generator=gen, device=dev).to(q_dtype)
        k = torch.randn((b, w, kk, hd), generator=gen, device=dev).to(bf16)
        v = torch.randn((b, w, kk, hd), generator=gen, device=dev).to(bf16)
        sp = torch.arange(w, dtype=torch.int32, device=dev)
        sp[filled:] = -1
        pos = torch.tensor(max(filled - 1, 0), dtype=torch.int32, device=dev)
        da_shapes.append(dict(decode_vs_plain(torch, ops, q, k, v, sp, pos,
                                              label, window), label=label))
        del q, k, v
    torch.cuda.empty_cache()

    # -- path n: the other five LM families at their registered widths ---
    # path o's dry run starts here, beside path n (module docstring)
    o_procs = o_dryrun_start()
    try:
        l_n, da_n, vt_n = run_path_n(torch, ops, dev, card, profile)
    except BaseException:
        o_dryrun_stop(o_procs)
        raise
    torch.cuda.empty_cache()

    # -- path o: checkpoints and the dry run at full width -----------------
    lmo = path_o(torch, ops, dev, card, o_procs)
    torch.cuda.empty_cache()

    # -- path p: the examples at the reference examples' defaults ----------
    lmp = path_p(torch, ops, dev, card)
    torch.cuda.empty_cache()

    # -- path q: the partitioned dense LM step -----------------------------
    lmq = path_q(torch, ops, dev, card)
    torch.cuda.empty_cache()

    # -- path r: the DFL round partitioned inside each pod -----------------
    lmr = path_r(torch, ops, dev, card)
    torch.cuda.empty_cache()

    # -- path s: the partitioned MoE step ------------------------------------
    lms = path_s(torch, ops, dev, card)
    torch.cuda.empty_cache()

    # -- path t: the partitioned SSM and hybrid steps ----------------------
    lmt = path_t(torch, ops, dev, card)
    torch.cuda.empty_cache()

    # -- path u: the partitioned enc-dec and VLM steps ---------------------
    lmu = path_u(torch, ops, dev, card)

    by_path = {"a": l_plain, "b": l_edge, "c": l_node, "d": lmd["launches"],
               "d_int8_route": l_dq1, "e": lme["launches"], "f": l_fed,
               "g": l_ge, "n": {k: l_n.get(k, 0) for k in ops.LAUNCHES},
               "o": {k: sum(r[k] for r in lmo["launches"].values())
                     for k in ops.LAUNCHES},
               "p": lmp["total"], "q": lmq["launches"],
               "r": lmr["launches"], "s": lms["launches"],
               "t": lmt["launches"], "u": lmu["launches"],
               **sparse_launches,
               "h": {k: sum(lmh[r]["launches"][k]
                            for r in ("h0", "h1", "h2", "h3"))
                     for k in ops.LAUNCHES},
               "h_int8_route": lmh["hq"]["launches"],
               "i": {k: sum(lmi[r]["launches"][k] for r in ("i0", "i1", "i2"))
                     for k in ops.LAUNCHES},
               "i3": lmi["i3"]["launches"],
               "k": {k: sum(r["launches"][k] for r in lmk.values())
                     for k in ops.LAUNCHES},
               "l": {k: sum(r["launches"][k] for r in lml.values())
                     for k in ops.LAUNCHES},
               "l3": lmh["l3"]["on"]["launches"],
               "l4": lmi["l4"]["launches"],
               "j": {k: sum(r["launches"][k] for r in lmj["runs"].values())
                     for k in ops.LAUNCHES},
               "j_emnist": {k: sum(r["launches"][k]
                                   for r in lmj["emnist"].values())
                            for k in ops.LAUNCHES},
               **lmm["launches"]}

    def launches(name):
        return sum(p[name] for p in by_path.values())

    def entry(name, route_name, replaces, m, counter=None, **extra):
        counter = counter or name
        times = {key: m[key] for key in (
            "kernel_ms", "library_kernel_ms", "ms_cold", "kernel_ms_cold",
            "library_ms_cold", "library_kernel_ms_cold", "kernels_per_call")
            if key in m}
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{route_name}.cu",
                    replaces=replaces, launches=launches(counter),
                    launches_by_path={k: p[counter]
                                      for k, p in by_path.items()},
                    max_abs_err=m["max_abs_err"], ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                    bound_by=m["bound_by"], library_ms=m["library_ms"],
                    shape=m["shape"], **times, **extra)

    def at_j(m):
        """A kernel check at path j's shapes, for the kernels line."""
        return {k: v for k, v in m.items() if k != "kernel_names"}

    kernels = [
        entry("segment_neighbor_avg", "segment_avg",
              "src/repro/kernels/segment_avg.py:62", seg,
              path_j=at_j(lmj["seg"]), path_m=at_j(seg_m)),
        entry("gather_rows", "gather_rows",
              "src/repro/kernels/gather_rows.py:39", gat,
              every_slot_bound_ms=gat["every_slot_bound_ms"],
              path_m=at_j(gat_m)),
        entry("dequant_neighbor_avg_rows", "dequant_avg_rows",
              "src/repro/kernels/dequant_avg.py:79", dq, path_m=at_j(dq_m)),
        entry("vt_kl_loss_fwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:94", vt_main["fwd"],
              also_replaces="src/repro/kernels/vt_kl_loss.py:108",
              dtype=vt_main["fwd"]["dtype"], plan=vt_main["fwd"]["plan"],
              path_j=at_j(lmj["vt"]["fwd"]),
              path_j_emnist=at_j(lmj["vt_emnist"]["fwd"]),
              path_m=at_j(vt_mlp[8 * 32]["fwd"]),
              path_n={v: at_j(r["fwd"]) for v, r in vt_n.items()}),
        entry("vt_kl_loss_bwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:127", vt_main["bwd"],
              dtype=vt_main["bwd"]["dtype"], plan=vt_main["bwd"]["plan"],
              path_j=at_j(lmj["vt"]["bwd"]),
              path_j_emnist=at_j(lmj["vt_emnist"]["bwd"]),
              path_m=at_j(vt_mlp[8 * 32]["bwd"]),
              path_n={v: at_j(r["bwd"]) for v, r in vt_n.items()}),
        entry("decdiff_update_sumsq", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:42", eq5["sumsq"],
              counter="decdiff_update", dtype=eq5["sumsq"]["dtype"],
              path_j=at_j(lmj["eq5"]["sumsq"]),
              path_m=at_j(eq5_m["sumsq"])),
        entry("decdiff_update_step", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:60", eq5["step"],
              counter="decdiff_update", dtype=eq5["step"]["dtype"],
              path_j=at_j(lmj["eq5"]["step"]),
              path_m=at_j(eq5_m["step"])),
        entry("decode_attention_fused", "decode_attention",
              "src/repro/kernels/decode_attention.py:92", da_main,
              dtype=da_main["dtype"], other_shapes=da_shapes,
              path_n=[at_j(m) for m in da_n]),
        entry("neighbor_avg", "neighbor_avg",
              "src/repro/kernels/neighbor_avg.py:32", nav_f,
              other_shapes=[nav_lm, nav_odd], path_j=at_j(lmj["nav"])),
        entry("dequant_segment_neighbor_avg", "dequant_segment_avg",
              "src/repro/kernels/segment_avg.py:81", dqs_main,
              fp32_route_err=dqs_main["fp32_route_err"],
              other_shapes=lmh["bucket_checks"]),
        entry("dequant_neighbor_avg", "dequant_avg",
              "src/repro/kernels/dequant_avg.py:42", dqa_main),
        # path r's split Eq. 5: pass A over the counted spans, the scale
        # kernel twice around the all-reduce, pass B (one launch count)
        entry("decdiff_update_split", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:42", lmr["split"],
              counter="decdiff_update",
              also_replaces="src/repro/kernels/decdiff_update.py:60",
              dtype=lmr["split"]["dtype"],
              counted_columns=lmr["split"]["counted_columns"],
              norm_err=lmr["split"]["norm_err"], path_s=at_j(lms["split"]),
              path_t=at_j(lmt["split"]), path_u=at_j(lmu["split"])),
        entry("drift_norms", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:42", drift,
              other_shapes=[at_j(drift_c)], path_m=at_j(drift_m)),
        # path q's split forms: the main path's shard ([512, 75968] fp32,
        # hd 32 of 64) first, the other shard counts and dtypes beside
        entry("vt_kl_partial_fwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:94",
              at_j(lmq["vt"]["torch.float32", 2]["fwd"]),
              also_replaces="src/repro/kernels/vt_kl_loss.py:108",
              other_shapes=[at_j(c["fwd"]) for key, c in lmq["vt"].items()
                            if key != ("torch.float32", 2)],
              path_s=[at_j(c["fwd"]) for c in lms["vt"].values()],
              path_t=[at_j(c["fwd"]) for c in lmt["vt"].values()],
              path_u=[at_j(c["fwd"]) for c in lmu["vt"].values()]),
        entry("vt_kl_shard_bwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:127",
              at_j(lmq["vt"]["torch.float32", 2]["bwd"]),
              other_shapes=[at_j(c["bwd"]) for key, c in lmq["vt"].items()
                            if key != ("torch.float32", 2)],
              path_s=[at_j(c["bwd"]) for c in lms["vt"].values()],
              path_t=[at_j(c["bwd"]) for c in lmt["vt"].values()],
              path_u=[at_j(c["bwd"]) for c in lmu["vt"].values()]),
        entry("decode_scores_partial", "decode_attention_split",
              "src/repro/kernels/decode_attention.py:92",
              at_j(lmq["da"][2]["scores"]),
              library_pretransposed_kernel_ms=lmq["da"][2]["scores"][
                  "library_pretransposed_kernel_ms"],
              other_shapes=[at_j(lmq["da"][n]["scores"])
                            for n in Q_SHARDS[1:]]
              + [at_j(m["scores"]) for m in lmq["da_gqa"].values()],
              path_q1=[c["scores"] for c in lmq["da_q1"].values()],
              path_s=[at_j(c["scores"]) for c in lms["da"].values()],
              path_t=[at_j(c["scores"]) for c in lmt["da"].values()],
              path_u=[at_j(c["scores"]) for c in lmu["da"].values()]),
        entry("decode_softmax_combine", "decode_attention_split",
              "src/repro/kernels/decode_attention.py:92",
              at_j(lmq["da"][2]["combine"]),
              other_shapes=[at_j(lmq["da"][n]["combine"])
                            for n in Q_SHARDS[1:]]
              + [at_j(m["combine"]) for m in lmq["da_gqa"].values()],
              path_q1=[c["combine"] for c in lmq["da_q1"].values()],
              path_s=[at_j(c["combine"]) for c in lms["da"].values()],
              path_t=[at_j(c["combine"]) for c in lmt["da"].values()],
              path_u=[at_j(c["combine"]) for c in lmu["da"].values()]),
    ]
    print(f"path d: ms per round {lmd['ms']}, peak device memory "
          f"{lmd['peak']} B, losses {lmd['losses']}")
    print(f"path e: ms per decode step median "
          f"{statistics.median(lme['ms']):.3f} (min {min(lme['ms']):.3f}, "
          f"max {max(lme['ms']):.3f}), {lme['tok_s']:.1f} tokens per second, "
          f"peak device memory {lme['peak']} B, decode_attention_fused "
          f"launches {lme['launches']['decode_attention_fused']}")
    print(f"paths f / g: ms per round {ms_fed:.2f} / {ms_ge:.2f}, "
          f"neighbor_avg launches {l_fed['neighbor_avg']} / "
          f"{l_ge['neighbor_avg']}, segment_neighbor_avg launches "
          f"{l_fed['segment_neighbor_avg']} / {l_ge['segment_neighbor_avg']}")
    print("path h (256 nodes, sparse, full MLP width): " + "; ".join(
        f"{k} {lmh[k]['ms']:.2f} ms per round, peak "
        f"{lmh[k]['peak'] / 2**30:.2f} GiB"
        for k in ("h0", "h1", "h2", "h3")))
    print("path i (10,000 nodes, sparse): " + "; ".join(
        f"{k} {lmi[k]['rps']:.2f} rounds per second, bytes "
        f"{lmi[k]['bytes']:.0f}, triggered {lmi[k]['trig']}"
        for k in ("i0", "i1", "i2", "i3")))
    print(f"path i3 (EdgeDropout(p=0.2)): live fraction per round "
          f"{lmi['i3']['live']}")
    print(f"path k (16 nodes, full-width MLP, {card}): " + "; ".join(
        f"{k} {r['ms']:.2f} ms per round, peak {r['peak'] / 2**30:.2f} GiB "
        f"({r['rise'] / 2**30:.2f} above the run's start), "
        f"live_edge_frac {r['live_frac']}, arrived_frac {r['arrived_frac']}, "
        f"sim_time {r['sim_time']}" for k, r in lmk.items())
        + f"; path k in all {k_s:.1f} s")
    print(f"path l (telemetry, {card}): l0 ms per round off "
          f"{lml['l0']['ms_off']}, on {lml['l0']['ms_on']} (ratio "
          f"{sum(lml['l0']['ms_on']) / sum(lml['l0']['ms_off']):.4f}); l1 "
          f"sparse {lml['l1_sparse']['ms']:.2f}, loop "
          f"{lml['l1_loop']['ms']:.2f}; l2 off / on "
          f"{lml['l2']['ms_off']:.2f} / {lml['l2']['ms_on']:.2f}, fedavg "
          f"{lml['l2_fedavg']['ms_off']:.2f} / {lml['l2_fedavg']['ms_on']:.2f};"
          f" l3 ms off / on {lmh['l3']['off']['ms']:.2f} / "
          f"{lmh['l3']['on']['ms']:.2f}, peak off / on "
          f"{lmh['l3']['off']['peak']} / {lmh['l3']['on']['peak']} B (rise "
          f"{lmh['l3']['off']['rise']} / {lmh['l3']['on']['rise']} B); l4 "
          f"rounds per second off {lmi['l4']['rps_off']}, on "
          f"{lmi['l4']['rps_on']}, with the ledger "
          f"{lmi['l4']['rps_ledger']}; l0-l2 in {l_s:.1f} s")
    print(f"path j (50 nodes, synth-fashion, Table I CNN, {card}): "
          + "; ".join(f"{m} {statistics.median(r['ms']):.2f} ms per round, "
                      f"peak {r['peak'] / 2**30:.2f} GiB, accuracy "
                      f"{r['history'][-1].acc_mean:.4f}"
                      for m, r in lmj["runs"].items())
          + f"; centralized {lmj['central_s']:.2f} s for 1 epoch, accuracy "
            f"{lmj['central_acc']:.4f}; synth-emnist "
          + "; ".join(f"{m} {statistics.median(r['ms']):.2f} ms per round, "
                      f"peak {r['peak'] / 2**30:.2f} GiB"
                      for m, r in lmj["emnist"].items()))
    print(f"path m (the pod backend, {card}): " + "; ".join(
        f"{k} ms per round {v['ms'] if 'ms' in v else ''}"
        for k, v in lmm.items() if k != "launches")
        + f"; path a {ms_plain:.2f}, path d {lmd['ms']}; path m in all "
          f"{m_s:.1f} s")
    print(f"path o (checkpoints and the dry run, {card}): checkpoint "
          f"{lmo['ckpt_bytes'] / 1e9:.3f} GB, write {lmo['write_s']:.2f} s, "
          f"read {lmo['read_s']:.2f} s; o1 {lmo['o1_s']:.1f} s; dry run "
          + ", ".join(f"{k} {v:.1f} s" for k, v in lmo["dryrun_s"].items())
          + f"; path o in all {lmo['s']:.1f} s")
    print(f"path p (the examples, {card}): seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in lmp["s"].items())
        + f"; ms per round {p_ms_text(lmp['ms'])}; Table II "
        + ", ".join(f"{m} {r['acc']:.4f} ± {r['std']:.4f}"
                    for m, r in lmp["tables"].items())
        + f"; Table IV {lmp['char_times']}")
    print(f"path q (the partitioned step, {card}): bf16 ms per step "
          f"unpartitioned {lmq['ms']['unpartitioned_bf16']}, (1, 2) "
          f"{lmq['ms']['partitioned_bf16']}")
    print(f"path r (the round partitioned inside each pod, {card}): bf16 "
          f"ms per round unpartitioned {lmr['ms']['unpartitioned_bf16']}, "
          f"(2, 1, 2) by rank {lmr['ms']['partitioned_bf16']}")
    print(f"path s (the partitioned MoE step, {card}): bf16 mixtral train "
          f"ms unpartitioned {lms['ms']['unpartitioned_bf16']}, (1, 2) by "
          f"rank {lms['ms']['partitioned_bf16']}")
    print(f"path t (the partitioned SSM and hybrid steps, {card}): bf16 "
          f"train ms " + "; ".join(
              f"{arch} unpartitioned {m['unpartitioned_bf16']}, (1, 2) by "
              f"rank {m['partitioned_bf16']}"
              for arch, m in lmt["ms"].items())
          + f"; path t in all {lmt['s']:.1f} s")
    print(f"path u (the partitioned enc-dec and VLM steps, {card}): bf16 "
          f"train ms " + "; ".join(
              f"{arch} unpartitioned {m['unpartitioned_bf16']}, (1, 2) by "
              f"rank {m['partitioned_bf16']}"
              for arch, m in lmu["ms"].items())
          + f"; path u in all {lmu['s']:.1f} s")
    print(f"chip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
