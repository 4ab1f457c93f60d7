#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (each logged with the script's elapsed seconds); any
failure raises, and the script then exits non-zero without printing a
result (the VLM and audio families' model paths run in
chip_smoke_media.py, beside this script; their kernels are checked at
their shapes here, in phase 3):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds every kernel in src/repro_torch/csrc/ into build/,
   one process per source, all started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shape sets of tests/test_kernels.py and at the serving paths'
   shapes, with the tolerances of tests/test_kernels.py; the bf16 flash
   kernel also at ragged S, head dims 16, 80 and 112, GQA 4:1, non-causal
   and on views of one fused (B, S, 3, H, D) buffer, and decode attention
   at cache_len 1, 0 and the whole buffer; WKV6 and SSD also at strong
   decays against the sequential oracles of kernels/ref.py (each in fp32,
   which takes its scalar kernel, and in bf16, which takes its chunked
   tensor-core kernel; flash and decode attention also at llama4-scout's
   GQA of 40 query heads on 8 kv heads, head dim 128, in fp32 and bf16,
   flash also at its 4x2048 prefill shape; flash at musicgen-large's
   4x2048 prefill shape (32 heads on 32 of 64) in fp32 and bf16 and at
   llama-3.2-vision-11b's (32 on 8 of 128, mistral-nemo-12b's heads
   too), decode attention at their serving shapes; flash at qwen3-32b's
   4x2048 prefill shape (64 query heads on 8 kv heads of 128: GQA 8:1)
   and decode attention at its serving shape (4 slots of 256), each in
   fp32 and bf16 and timed beside its plain version, SDPA (``enable_gqa``)
   and its bound;
   bf16 SSD also at S of 1, 63, 64, 65 and 601, P of
   16, 32 and 128, N of 8 and 64, two groups; bf16 WKV6 also at S of 1, 63,
   64, 65 and 601 and K of 16, 32 and 64 on strided views of one
   projection, and a misaligned view must raise); that one decode attention
   call, one bf16 SSD call and one bf16 WKV6 call each run one CUDA kernel;
   the times of each
   kernel, its plain version and, where one PyTorch call computes the same
   function (SDPA for the attention kernels, which the port never calls;
   none for WKV6 or SSD), that call, at the serving paths' shapes (flash
   also at zamba2-7b's, llama4-scout's, musicgen-large's and
   llama-3.2-vision-11b's prefill shapes), beside the card's bound (the
   bounds' arithmetic is the autotuner's ``KernelSpec.cost``); flash and
   decode at a rank's 8 of olmo-1b's 16 heads (phase 10's), flash (bf16
   4x2048) and decode (fp32, phase 11's ticks) at a rank's heads of
   zamba2-7b's shared block (16 of 32 of 112), llama-3.2-vision-11b (16
   on 4 kv of 128) and musicgen-large (16 of 32 of 64), all phase 11's
   (``mesh_kernel_times``), WKV6 at a rank's 32 of rwkv6-7b's 64 heads and
   SSD at 56 of zamba2-7b's 112 (phase 11's, ``scan_kernel_times``),
   decode with ``return_lse`` (fp32 o and lse) at a rank's shard of 16384
   positions, bf16, batch 1, at qwen3-8b's heads (32:8 of 128) and
   zamba2-7b's shared block's (32:32 of 112), and at the same heads
   without it over the whole 32768 (phase 12's, ``kvseq_kernel_times``:
   the partial softmax at ``TOL["float32"]``, the whole 32768's bf16 o at
   rtol 2e-2, atol 1e-4; each check must refuse the plain version over
   90% of the positions), the others held against their plain versions at
   ``TOL`` of their dtype, each timed
   beside its plain version, SDPA where it applies, and its bound; then the
   autotuner's knobs (5–20 s): each bf16 chunked WKV6 and SSD
   instance's registers, spills, shared memory and CTAs per SM; every rung
   of each kernel's knob (flash's ``group``, decode's ``split``, WKV6's
   ``value_tile``, SSD's ``state_tile``) at its first serving shape, timed
   as the tuner times a candidate and held against the fp32 plain version
   within tests/test_kernels.py's bf16 tolerance, flash's every group
   bit-equal to its default; then
   ``autotune_all`` at ``SERVING_SHAPES`` (core/provision/autotune.py),
   the cache written to build/autotune_cache.json, one ``autotune:`` JSON
   line an entry (default and tuned config and us, speedup, roofline
   ceiling and fraction, max_err against tol, candidates, the card). The
   step's launches are taken off the counters again: the kernel table's
   launches are the main paths' alone;
4. reference: reduced olmo-1b, qwen3-8b, rwkv6-7b, zamba2-7b, olmoe-1b-7b,
   llama4-scout and mistral-nemo-12b, and qwen3-32b and mistral-nemo-12b
   at GQA 8:1 (16 query heads on 2 kv heads; their ``.reduced()`` keeps 4
   on 1, and qwen3-32b's is qwen3-8b's) on the card (kernels) against the
   CPU (plain versions), fp32, prefill and decode logits; then olmo-1b,
   rwkv6-7b, zamba2-7b, olmoe-1b-7b, qwen3-32b and mistral-nemo-12b at full
   width but reduced depth, fp32, prefill (the prefill kernels) against
   serving (the decode path) on the card, within 1e-3 of the logits' range
   (olmoe at the no-drop capacity, see no_drop);
5. slices, one per model at full width from seeded random weights (bf16
   compute), freed before the next: olmo-1b (flash and decode attention),
   rwkv6-7b at 16 of its 32 layers (WKV6), zamba2-7b at 21 of its 81
   layers (3 periods of 5 Mamba-2 layers and the shared block, and 3
   trailing; Mamba-2 SSD, and flash and decode attention at head dim 112
   in the shared block), olmoe-1b-7b (64 experts, top-8, 4 of its 16
   layers; flash and decode attention; the three cut for the time
   limit), llama4-scout at 2 of its
   48 layers (16 experts, top-1 and a shared expert; flash and decode
   attention at GQA 40:8), and uncut qwen3-32b (64 layers, 64 query heads
   on 8 kv heads of 128: 64 flash launches a prefill call, 64 decode
   launches a tick) and mistral-nemo-12b (40 layers, 32 on 8 of 128: 40
   and 40), on llama4-scout's traffic. Every slice's bf16 weights are
   made in bf16 a layer at a time (``init_params(dtype=torch.bfloat16)``:
   qwen3-32b's 65.5 GB fit the card, its 131 GB fp32 tree would not).
   Each runs the prefill step on 4
   prompts of 2048 tokens (three calls, the first a warm-up), then the
   continuous-batching driver serving its requests on 4 slots (8; 4 for
   llama4-scout, qwen3-32b and mistral-nemo-12b), then each
   request's prompt through the prefill step, whose last logits must match
   the served ones within 5e-2 of their range, or within twice the model's
   own bf16 rounding error where that is larger (see check_parity; where
   the fp32 tree does not fit the card's free memory, as qwen3-32b's does
   not, the rounding is measured on a cut of the model to the most layers
   that fit, parity_layers: the slice's embedding, head and first layers;
   the ``parity:`` line names the bound that applied and its depth); an MoE
   model's per-request prefills and the gate's fp32 prefills run at the
   no-drop capacity, since a prefill at the real capacity drops choices
   that serving keeps, while its timed prefills and serving run the real
   config. An MoE request beyond its bound passes only where a router
   near-tie explains it (router_near_tie: an expert choice at its last
   token that differs between the two bf16 paths, within twice the bf16
   error of a tie in fp32, and the prefill with serving's choices forced
   within the bound). The launch counters are
   zeroed before each slice and must show each kernel of the model launched
   once per layer that runs it, per prefill call or per decode tick, and
   the other kernels not at all. A profiled window of SLICE_PROFILE_TICKS
   decode ticks follows,
   and for an MoE model a profiled prefill call; both report the MoE
   blocks' device ms, split into the expert products (``aten::bmm``) and
   the rest of the block.
6. train (the dense training path, fp32 params, AdamW; it runs no kernel,
   since no kernel has a backward): olmo-1b at full width and 2 layers,
   fp32, one train step on the card against the same step on the CPU at
   2x256 (full attention) and 1x1536 (chunked attention); olmo-1b and
   qwen3-8b at full width and 2 layers on the card, remat none, full and
   dots giving equal gradients, and the chunked attention's gradients
   against the full attention's at S = 1536; then olmo-1b at full width
   and depth, bf16 compute, remat "full", 4x2048 tokens of the synthetic
   pipeline: 6 steps (the first a warm-up), one step with 2 microbatches
   and one profiled step, with the launch counters at 0 throughout. It
   prints ms per step, tokens/s, peak memory and train_mfu, and the
   profiled step broken down into matmuls, attention einsums and the rest.
   Then the other families (the recurrent ones' train mode runs the
   differentiable scans ``wkv6_chunked`` and ``ssd_chunked``, the MoE's its
   plain block; no kernel), their zero-init leaves seeded: rwkv6-7b at full
   width and 1 layer, zamba2-7b at full width and 7 layers (one period and
   one trailing layer) and olmoe-1b-7b at full width and 1 layer, fp32,
   one train step on the card against the CPU at 2x200 (2x256 for olmoe,
   where choices drop at capacity, aux included), and remat none, full and
   dots giving equal gradients on the card at 1x1536; then rwkv6-7b at 8
   of its 32 layers, zamba2-7b at 21 of its 81 (3 periods and 3 trailing
   layers) and olmoe-1b-7b at 6 of its 16, each at full width, bf16
   compute, remat "full", 4x2048 tokens: 6 steps (the first a warm-up) and
   one profiled step, freed before the next, with the launch counters at
   0. Each prints a ``train:`` line like olmo-1b's (olmoe's model FLOPs
   count the active experts only), its profiled step split into
   ``aten::mm``, the scan (the ops under the scan's record_function, its
   forward and remat recompute, and the backward nodes of those ops),
   ``aten::bmm`` (for olmoe the expert products) and the rest.
7. checkpoints (ACAI's training jobs must survive preemption; no kernel
   launches): olmo-1b as in the train phase at 4 of its 16 layers (the
   script's time limit), under ``TrainSupervisor`` saving a 4.5 GB
   checkpoint (fp32 params, AdamW's mu and nu) to a data lake under build/
   every 2 steps, with a failure injected once at step 3: steps 0 and 1, a
   save at 2, step 2, the failure, a restore of step 2, steps 2 and 3
   again, a save at 4. It raises with less than 11 GB free there, and
   deletes the lake at the end. Gates: the report (1 restart, 2
   checkpoints, 5 steps run, final step 4), the lake's latest step and its
   two checkpoint entries with finite losses, the latest checkpoint
   restored into a fresh template on the card bit-equal to the live state,
   step 2's loss after the restore within 1e-6 relative of its loss before,
   and the launch counters at 0. It prints a ``checkpoint:`` line with the
   time and rate of each save and restore, ms per step, peak device memory
   and peak host RSS.
8. the platform (the paper's workflow as jobs through the port's
   ``AcaiPlatform`` with ``runner="thread"`` and one worker, so that jobs
   run one at a time on an engine thread), at olmo-1b's full width and
   depth in a data lake under build/ that it deletes at the end (it raises
   with less than 12 GB free there), as one pipeline: a data job that
   uploads the data description and makes fileset ``TrainData``; two
   training jobs after it (lr 3e-3 and 1e-4, 8 steps each as in the train
   phase), each saving its params
   (4.7 GB) with its job's provenance and printing its final loss as
   ``[[acai:final_loss=...]]``; then an eval job after both, which
   restores the run the metadata's ``find_min("final_loss")`` names, casts
   it to bf16, prefills each of phase 5's 8 olmo-1b requests (flash
   attention) and serves them (decode attention), printing its tokens/s.
   Gates: all four jobs FINISHED and one at a time; ``find_min`` names the
   job with the smaller final loss; both checkpoints lead back to
   ``TrainData:1``; the restored params' SHA-256 equals the saved ones';
   each train job's engine runtime at least the sum of its synchronized
   steps (a consistency check: a train job syncs after each step and its
   save copies to the host, so it leaves no work queued, and this gate
   would hold without the runner's wait for the card; the evidence for
   that wait is ``tests/test_torch_card.py::
   test_thread_runner_runtime_covers_queued_device_work``), and no kernel
   launched by them or the data job; the eval job's
   launches exactly 16 flash per prefill call and 16 decode per tick;
   device memory after
   each job (at its terminal event, after the runner's commit) within
   0.5 GB of its value when the job started. It prints an ``engine:`` line
   with each job's state, engine runtime beside its own step or serve
   time, save and restore seconds, device memory before, at peak and
   after, launches, and the eval job's tokens/s. The eval job's launches
   count in the kernel table's main-path launches.
9. durable (the control plane's journal, crash recovery and the subprocess
   runner, whose detached worker process runs the jobs and outlives the
   engine): ``AcaiPlatform(root, runner="subprocess", durable=True)`` over
   a root under build/ that it deletes at the end, with the jobs of
   ``repro_torch/examples/card_jobs.py`` (a job that crosses the process
   boundary must be importable). A probe job starts the worker, initialises
   CUDA there and finds the kernel libraries of phase 2 built. Then four
   steps:
   (1) two olmo-1b training jobs at full width and 4 of 16 layers (lr 3e-3
   and 1e-4, 6 steps of 4x2048, each printing ``[[acai:final_loss=...]]``)
   and a serve job (olmo-1b in bf16 at full width and depth, 4 of phase 5's
   requests) go in at once and run on three threads and three streams of
   the worker. Gates: all FINISHED; their runs overlap; three streams, none
   the default stream; each log holds only its own lines; ``find_min``
   names the train job with the smaller final loss; each train job's
   runtime at least the sum of its synchronized steps; the serve job's own
   launch counters exactly 16 flash launches per prefill call and 16
   decode launches per tick (they count in the kernel table's main-path
   launches). (2) A 12-step training job writes a progress file after each
   step; after step 2 the engine dies (store closed, socket dropped, no
   shutdown), and a new platform over the root recovers it: adopted 1,
   requeued 0; the job settles once, at epoch 0, and its marker file has
   one line. (3) The same job again; after step 2 the worker (the pid in
   ``worker.json``) is killed with SIGKILL and the engine dies. Gates:
   within 10 s the card's ``memory.used`` is back within 0.5 GB of its
   value before the phase (nvidia-smi's per-process list does not name
   the worker's pid on the card's machine; this process holds still
   through the phase, so the card's memory above that value is the
   worker's); a new platform recovers with requeued 1 and a new worker
   runs epoch 1 to FINISHED; the re-run's first loss equals the first
   loss of (2)'s run within 1e-6 relative. (4) Shutdown: every worker pid exits within 30 s,
   and the card's ``memory.used`` is back within 0.5 GB of its value
   before the phase. It prints a ``durable:`` JSON line: the worker's
   spawn-to-ready seconds, each job's engine runtime beside its own
   synchronized time, each recovery's seconds and report, the time from
   the SIGKILL to the card freeing the worker's memory, and the worker's
   memory (the card's ``memory.used`` above its value before the phase)
   once CUDA is ready, at its peak, between jobs and before the
   shutdown.
10. mesh (the sharded steps on a ``DeviceMesh``, one process per rank;
   ranks that share the card talk over gloo, which measures no
   interconnect): (1) a world of one rank on nccl: olmo-1b's sharded train
   step on a (1, 1) mesh at full width and 4 of 16 layers (fp32, remat
   full, MESH_TRAIN_STEPS (2, for the time limit) steps of
   4x2048) against the one-device step; gate: each loss within 1e-4
   relative; the one-device step of the first batch at 2 microbatches.
   (2) Two spawned ranks on gloo, mesh (1, 2): first MESH_TRAIN_STEPS
   train steps of olmo-1b at full width and MESH_TP_TRAIN_LAYERS (2) of
   16 layers, fp32, remat full, 4x2048, each rank holding its vocab
   columns of the logits (the loss's row max and sums all-reduced over
   "model"); gates: each rank's loss of each step and grad norm of the
   first (which holds the head's gradient) within 1e-4 relative of the
   one-device steps' (rank 0 runs them on the same init and batches),
   each rank's peak memory in the first step (reset after
   its state is built) within DRYRUN_PEAK_TOL of the dry-run's count of
   the same (1, 2) cell (``launch/dryrun.count_cell`` on fake tensors,
   counted by rank 0 before its process group starts); then
   olmo-1b at full width and depth in bf16, three 4x2048 prefills (16
   flash launches a rank a call, each at 8 of the 16 heads) and
   MESH_REQUESTS (1) of phase 5's requests served (the shortest; 16 decode launches a rank a tick, at 8 heads); gates: the launch counts and head counts, the prefill logits
   within 5e-2 of the one-device bf16 prefill's range, each request's
   served logits within 5e-2 of its sharded prefill's range; at 2 layers
   in fp32 the sharded prefill within 1e-3 of the one-device prefill's
   range; olmoe-1b-7b at full width and 2 of 16 layers, expert parallel
   (32 experts a rank) at the no-drop capacity, a fp32 4x512 prefill
   within 1e-3 of the no-mesh branch's range; compressed_psum (bf16 and
   int8) on the card's tensors equal to the sum of its ranks'
   round-trips, bit for bit; a 2-stage GPipe within 1e-5 of
   sequential_apply; the 2-layer fp32 params saved from (1, 2) and
   restored on one rank, bit for bit. (3) Two ranks, mesh (2, 1), FSDP
   and ZeRO-1: (a) the train steps of (1), each FSDP-sharded layer
   gathered over data where it runs (inside the checkpointed layer: the
   recompute gathers it again) and its gradient reduce-scattered back;
   gate: each loss within 1e-4 relative of the one-device step's; each
   rank's peak memory beside MESH_FSDP_WHOLE_PEAK_GB (7.93 GB: a rank's
   peak when the step gathered whole params and gradients) and the
   one-device step's; (b) the first batch's step at
   2 microbatches (the global batch's row blocks, each rank its share of
   each), its loss within 1e-4 relative of the one-device microbatched
   step's; (c) in the same world a (2, 1, 1) ("pod", "data", "model")
   mesh, the batch over "pod" and the gradients all-reduced over it: the
   first step, its loss within 1e-4 relative of one device's; olmo-1b at
   full width and 2 of 16 layers, batch 4 in the "fsdp" layout (2 rows a
   rank), a fp32 4x512 prefill and 8 fp32 teacher-forced ticks within
   1e-3 of the one-device range, then a bf16 4x2048 prefill (within 5e-2
   of the one-device bf16 prefill's range) and 8 bf16 ticks, whose
   launches must be flash 2 a prefill call and decode 2 a tick, each at
   the rank's 2 rows, and no other kernel. (Phase 3 times the flash and
   decode kernels at a
   rank's 8 of olmo-1b's 16 heads, where the kernel table's timings are:
   in phase 10, after an nccl group in this process, the profiler's
   windows lost kernel records.) It prints a ``mesh:`` JSON line (backends,
   ranks, each rank's launches, ms per prefill and per tick, peak memory,
   which gloo collectives took CUDA tensors, every gate's reading and
   limit, each (2, 1) rank's peak beside 7.93 GB); the prefill and
   serving launches of (2) and (c)'s bf16 launches count in the kernel
   table's main-path launches.
11. mesh families (the recurrent, hybrid, VLM and audio layouts on a
   ``DeviceMesh``; budget 120 s): two spawned gloo ranks sharing the card,
   mesh (1, 2), each model of MESH_FAMILIES at full width and cut depth
   from seeded weights (rwkv6-7b 2 of 32 layers, zamba2-7b one period of
   5 Mamba-2 layers and the shared block, llama-3.2-vision-11b one period
   of 4 dense and 1 cross-attention layer with 4 seeded vision states of
   1601 x 1280, musicgen-large 4 of 48 layers over 4 codebooks), freed in
   turn. Rank 0 runs the one-device port first, then both ranks the
   sharded steps. Gates (rank 0): a fp32 4x512 prefill within 1e-3 of the
   one-device prefill's range; 16 fp32 teacher-forced serving ticks of
   the sharded serve step (its decode state built by
   ``init_sharded_decode_state``: the rank's heads of the wkv and SSM
   states, an even share of the conv state's channels, the VLM's vision
   K/V whole) within 1e-3 of the one-device ticks' range; zamba2-7b's
   fp32 4x512 train step's loss within 1e-4 relative of the one-device
   step's; a bf16 4x2048 prefill (two calls, the first a warm-up) within
   5e-2 of the one-device bf16 prefill's range, or twice the model's own
   bf16 rounding error (the one-device bf16 prefill against its fp32
   prefill) where that is larger, as phase 5 rules. Gates (each rank):
   the launches of a bf16 prefill call, WKV6 2, SSD 5 and flash 1, flash
   4 and flash 4 (the VLM's cross-attention runs none), each launch at
   the rank's heads (32 of 64, 56 and 16 of 112 and 32, 16 of 32, 16 of
   32). It prints a ``mesh_families:`` JSON line (each rank's ms per
   sharded and one-device prefill and tick, its peak memory during the
   sharded bf16 prefill and in the phase, launches, heads, every gate's
   reading and limit, the phase's seconds); the bf16 prefill launches
   count in the kernel table's main-path launches.
12. kvseq (decode states whose KV sequence shards over the mesh; budget
   90 s): two spawned gloo ranks sharing the card, mesh (2, 1), each
   model of KVSEQ_RUNS at full width and cut depth from seeded weights:
   qwen3-8b (2 of 36 layers, batch 1) and zamba2-7b (one period, 6
   layers, batch 1: ``long_500k``'s layout), whose KV sequence shards
   over ("data", "model"), and olmo-1b (2 of 16 layers, batch 4), whose
   batch "resident" replicates, all under the "resident" serving layout
   (the params replicated: at batch 1 "fsdp" gives the same decode state
   specs, and its per-call gather of the params through gloo's host
   memory would take seconds a tick). Each buffer holds 32768 positions,
   16384 a rank; the decode state (KV caches and Mamba states) is seeded
   whole from one seed on each rank, which takes its shard. 16
   teacher-forced ticks start at cache_len 16376, so the batch-1 models'
   writes cross the ranks' edge at 16384; olmo-1b's rows start at 16376,
   20480, 24576 and 32000, so that rank 1's shard carries a fifth to half
   of a row's softmax weight (every seeded position is valid); each rank's
   decode kernel runs over its shard and returns a partial softmax
   (``return_lse``), and the ranks merge theirs (one gather of
   (B, H, D + 1) floats a layer). fp32, then bf16 (the weights cast in
   place); each rank runs the one-device fp32 ticks, rank 0 the bf16 ones.
   On (2, 1) the KV sequence shards over data only: the path where
   "model" shards it (q gathered to every head) runs in the CPU tests
   alone. Gates (rank 0): the bf16 ticks within 5e-2 of the one-device
   bf16 ticks' range, or twice the model's own bf16 rounding error where
   that is larger. Gates (each rank): the fp32 ticks within 1e-5 of the
   one-device ticks' range; its cache shards after the fp32 ticks equal to
   its part of the one-device caches within 1e-6 of their range; the decode
   launches of a bf16 tick (qwen3-8b 2, zamba2-7b 1, olmo-1b 2), each over
   16384 positions, and no other kernel; no collective of a tick (fp32 or
   bf16) as large as one layer's cache shard (``spmd.watch_collectives``,
   which sees torch.distributed's and DTensor's collectives). It prints a
   ``kvseq:`` JSON
   line (each rank's ms a tick, sharded and one device's, its cache bytes
   beside one device's, peak memory, launches, every gate's reading and
   limit, the phase's seconds); the bf16 ticks' launches count in the
   kernel table's main-path launches.

13. dryrun (``launch/dryrun.py``, the counted cells; budget 40 s): one
   spawned process (a fake process group needs a process without the real
   one) counts olmo-1b's cells on a fake (1, 1) mesh, once on fake CUDA
   tensors and once on fake CPU tensors: phase 10's (1, 1) train step (4 of
   16 layers, fp32, remat full, 4x2048), the uncut bf16 prefill of 4x2048
   (fp32 params, as the dry-run's cell) and a tick of 4 slots of a 2048
   buffer; then it runs the same steps on a real (1, 1) mesh (nccl, one
   rank): 1 + DRYRUN_TIMED train steps and prefill calls, DRYRUN_TICKS
   ticks. Gates: every field that the program fixes (FLOPs, bytes, fused
   bytes, collectives by kind, the kernel records) equal on both devices;
   16 flash records in the prefill's count and 16 decode records in the
   tick's, each at ``KernelSpec.cost`` of its shape (4, 2048, 16:16 of 128,
   bf16; decode over the whole buffer), and each real prefill call and
   tick advancing its counter by 16; the roofline's ``step_time_s`` (H100
   constants) of the train step and of the prefill not above the measured
   median; the train step's predicted peak (arguments + temp) within 25%
   of ``torch.cuda.max_memory_allocated`` for a measured step. It prints a
   ``dryrun:`` JSON line (each cell's counts, count seconds, roofline
   terms, measured ms and their ratio, the peaks, the phase's seconds);
   the real calls' launches count in the kernel table's main-path
   launches.

14. examples (the paper's serving and sweep workflows as the port's
   examples; budget 30 s): ``repro_torch.examples.serve_batch.run`` at
   --full (published width and depth, random weights from seed 0 cast to
   bf16 once, the reference's batch 4, prompts of 8 and 12 new tokens:
   19 ticks) for olmo-1b and zamba2-7b, through
   ``serve.decode.greedy_generate``. Gates: the decode launches exactly
   one a tick per layer that attends (olmo-1b 16, zamba2-7b's shared block
   13 a tick) and no other kernel, each launch at the model's (heads,
   head dim): (16, 128) and (32, 112); tokens of (4, 12) in the vocab.
   Then the same run in fp32 (the decode kernel at fp32) against one
   forward over the prompt and the tokens, which keeps no decode state:
   at each generated position the forward's row max less its logit of
   the token chosen, over the row's range, within EXAMPLES_GAP (a token
   read from a wrong slot or a stale state is not the forward's argmax);
   the bf16 run's share of tokens equal to the fp32 run's is printed, and
   at each row's first step where the bf16 tokens leave the fp32 ones
   (``first_flips``) the fp32 forward's top-2 margin must be at most twice
   the bf16 forward's logit error there: a near-tie, not a fault (ROADMAP
   C). Then ``hyperparam_sweep.main`` on the card and on the CPU (each root
   under build/, deleted): the 10 stages FINISHED, 16 DAG edges, the
   broken pipeline's states and the best job's metadata keys those of the
   CPU run, every sweep job's tensors on the card (its outputs, not its
   metadata), no kernel launched by the sweep. It prints an
   ``examples:`` JSON line (each model's seconds, ms a tick, launches,
   heads and peak memory; each sweep's stages, held count, states, edges,
   broken pipeline and seconds; every gate's reading and limit; the
   phase's seconds); the decode launches count in the kernel table's
   main-path launches.

The last three lines are the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import re
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the kernels' device time (the kernel table's, tools/attention_ab.py's and
# the autotuner's); kernel_rows also splits the profiles of ticks and steps,
# and tests/test_torch_timing.py reads launches_of here
from repro_torch.kernels.timing import (  # noqa: E402
    flushed_ms, kernel_count, kernel_rows as _kernel_rows, launches_of,
    l2_flush_buffer)

# H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
# tensor cores, HBM3 bandwidth (all at the full 700 W power limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}   # tests/test_kernels.py
# tests/test_kernels.py's fp32 tolerances for the recurrences
TOL_WKV6 = {"bfloat16": (2e-2, 2e-2), "float32": (2e-4, 2e-4)}
TOL_SSD = {"bfloat16": (2e-2, 2e-2), "float32": (5e-4, 5e-4)}

PREFILL_BATCH, PREFILL_LEN = 4, 2048
# phase 4: the reduced dense configs at GQA 8:1 (tests/test_torch_dense_large.py)
REDUCED_GQA8 = {"n_heads": 16, "n_kv_heads": 2}
FLASH_CASES = [  # (b, s, h, kv, d, causal, dtype)
    *[(*shape, True, dt)
      for shape in [(1, 256, 4, 4, 64), (2, 256, 4, 2, 32), (1, 512, 8, 2, 64),
                    (1, 128, 2, 1, 128)]
      for dt in ("float32", "bfloat16")],
    (1, 256, 2, 2, 64, False, "float32"),
    *[(*shape, causal, "float32")
      for shape in [(1, 192, 2, 2, 80), (2, 320, 4, 2, 96), (1, 100, 2, 1, 64)]
      for causal in (True, False)],
    # the bf16 kernel's edges: ragged S, head dims 16, 80 and 112 below its
    # 64/112/128 tile widths, GQA 4:1, causal and not
    *[(*shape, causal, "bfloat16")
      for shape in [(1, 100, 2, 1, 64), (2, 601, 8, 2, 80), (1, 601, 4, 1, 16),
                    (2, 300, 8, 2, 112)]
      for causal in (True, False)],
    # zamba2-7b's shared attention block: head dim 112, and its prefill shape
    (2, 200, 4, 4, 112, True, "float32"), (1, 256, 4, 4, 112, True, "bfloat16"),
    (4, 2048, 32, 32, 112, True, "bfloat16"),
    # llama4-scout's GQA: 40 query heads on 8 kv heads (5:1), head dim 128,
    # and its prefill shape
    (1, 256, 40, 8, 128, True, "float32"),
    (PREFILL_BATCH, PREFILL_LEN, 40, 8, 128, True, "bfloat16"),
    # musicgen-large's prefill shape (32 heads on 32 of 64: the bf16
    # kernel's 64-wide tile) in both dtypes; llama-3.2-vision-11b's (32 on
    # 8 of 128)
    *[(PREFILL_BATCH, PREFILL_LEN, 32, 32, 64, True, dt)
      for dt in ("float32", "bfloat16")],
    (PREFILL_BATCH, PREFILL_LEN, 32, 8, 128, True, "bfloat16"),
]
DECODE_CASES = [  # (b, s, h, kv, d, dtype), seeded random cache_len
    *[(*shape, dt) for shape in [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32)]
      for dt in ("float32", "bfloat16")],
    (3, 300, 4, 2, 128, "float32"),
    (2, 300, 4, 4, 112, "float32"), (4, 512, 32, 32, 112, "bfloat16"),
    # llama4-scout's GQA 40:8 at head dim 128
    (2, 300, 40, 8, 128, "float32"), (4, 256, 40, 8, 128, "bfloat16"),
    # musicgen-large's serving shape (32 heads on 32 of 64, a buffer of
    # 256 + 32) in both dtypes; llama-3.2-vision-11b's (32 on 8 of 128)
    *[(4, 288, 32, 32, 64, dt) for dt in ("float32", "bfloat16")],
    (4, 288, 32, 8, 128, "bfloat16"),
]
# qwen3-32b's prefill shape (64 on 8 kv heads of 128: GQA 8:1) and serving
# shape (4 slots of 256, a group of 8 query heads a kv head per CTA), each
# in both dtypes; mistral-nemo-12b's heads (32 on 8 of 128) are the VLM's
# in FLASH_CASES. Their inputs come from a generator of their own, so that
# the cases above, and the olmo-1b shapes of the kernel table after them,
# draw what they drew before these came
QWEN_FLASH_CASES = [(PREFILL_BATCH, PREFILL_LEN, 64, 8, 128, True, dt)
                    for dt in ("float32", "bfloat16")]
QWEN_DECODE_CASES = [(4, 256, 64, 8, 128, dt)
                     for dt in ("float32", "bfloat16")]
# cache_len 1, the whole buffer, 0 (zeros) and s // 2 + 3; GQA 4:1, D = 112
DECODE_EDGE_CASES = [(*shape, dt) for shape in [
    (4, 1024, 16, 16, 128), (3, 512, 8, 2, 128), (3, 300, 16, 4, 112)]
    for dt in ("float32", "bfloat16")]
WKV6_CASES = [  # (b, s, h, k, dtype of r, k, v); logw and u are fp32
    (b, s, h, k, dt) for b, s, h, k in [(1, 128, 2, 32), (2, 256, 4, 64),
                                        (1, 64, 1, 16), (1, 601, 2, 64)]
    for dt in ("float32", "bfloat16")]
# the bf16 chunked kernel's edges, on strided views of one projection: S
# around its 64-token chunk and a ragged tail, K below and at its tile
WKV6_EDGE_CASES = [(2, s, 4, k) for s in (1, 63, 64, 65, 601)
                   for k in (16, 32, 64)]
SSD_CASES = [  # (b, s, h, p, g, n, dtype of x, B, C); dt, A and D are fp32
    *[(*shape, dt) for shape in [(1, 128, 2, 32, 1, 16), (2, 256, 4, 64, 2, 32),
                                 (1, 64, 2, 16, 1, 8), (1, 601, 4, 64, 1, 64)]
      for dt in ("float32", "bfloat16")],
    # the bf16 chunked kernel's edges: S around its 64-token chunk and a
    # ragged tail, P below, at and above its 64-column tile, N of 8 and 64
    *[(2, s, 4, p, 2, n, "bfloat16") for s in (1, 63, 64, 65, 601)
      for p, n in ((16, 8), (32, 64), (128, 64), (128, 8))],
]
# the full-width train phase: olmo-1b, 4x2048 tokens a step, timed steps
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 2048, 6
# the families trained at full width and reduced depth: layers of the timed
# run (fp32 params, grads and AdamW moments take 16 bytes a param: 36.7,
# 29.4 and 43.6 GB), layers and sequence length of the fp32 parity step
# (batch 2), its gradient gate (of each leaf's largest entry), and the
# scan's record_function (None: no scan); the train steps' peak may not
# pass TRAIN_PEAK_BYTES (zamba2-7b at 27 layers, 35.7 GB, peaked at
# 73.9 GB on an H100: its shared block's sites keep their activations
# outside remat)
TRAIN_FAMILIES = {"rwkv6-7b": (8, 1, 200, 2e-4, "wkv6_chunked"),
                  "zamba2-7b": (21, 7, 200, 1e-4, "ssd_chunked"),
                  "olmoe-1b-7b": (6, 1, 256, 1e-4, None)}
TRAIN_PEAK_BYTES = 70e9
# the checkpoint phase: olmo-1b's layers (4 of 16, for the script's time
# limit once the mesh phase came: at 16 the phase took 2.2-2.4 minutes on
# an H100, at 8 about 1.4), supervised steps, a save every 2, a failure at
# step 3; the lake needs two checkpoints of 4.5 GB and room
CKPT_LAYERS, CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_FAIL_AT = 4, 4, 2, 3
CKPT_MIN_FREE = 11e9
# the platform phase: two training jobs (one per learning rate) of this
# many steps, the free disk it needs under build/ (two 4.7 GB saves), and
# how far device memory may stay above its value before a job
PLATFORM_LRS, PLATFORM_STEPS, PLATFORM_MIN_FREE = (3e-3, 1e-4), 8, 12e9
MEMORY_RETURN_BYTES = 0.5e9
# the durable phase: olmo-1b's layers in its training jobs, the steps of the
# two overlapping jobs and of the job that outlives its engine and worker,
# and the number of phase 5's olmo-1b requests its serve job serves
DURABLE_LAYERS, DURABLE_STEPS, DURABLE_RECOVER_STEPS = 4, 6, 12
DURABLE_REQUESTS = 4
# per model: slots, cache buffer, requests, new tokens each, prompt lengths;
# SLICE_LAYERS cuts a model's depth (llama4-scout's 48 layers take 215 GB
# in bf16; 2 layers, 6.47 B params, take 12.9 GB; zamba2-7b's 81 layers
# took 99-105 s of the script's 1200 s limit, 21 (3 periods and the 3
# trailing layers) keep its layout; olmoe-1b-7b's 16 layers took 81-115 s,
# so 4 run; rwkv6-7b's 32 layers took 63 s, so 16 run: the mesh phase's
# per-layer FSDP steps, microbatch step and pod mesh took 50 s more).
# qwen3-32b and mistral-nemo-12b run uncut on llama4-scout's traffic: 22.5
# and 11.1 s on an H100 with a fast host, 39.7 and 18.4 s with a slow one
# (8-tick profiles, the parity gate included), 67.3 and 25.7 GB at peak
SLICES = {"olmo-1b": (4, 1024, 8, 32, (128, 512)),
          "rwkv6-7b": (4, 512, 8, 16, (64, 256)),
          "zamba2-7b": (4, 512, 8, 16, (64, 256)),
          "olmoe-1b-7b": (4, 1024, 8, 32, (128, 512)),
          "llama4-scout-17b-a16e": (4, 256, 4, 16, (64, 128)),
          "qwen3-32b": (4, 256, 4, 16, (64, 128)),
          "mistral-nemo-12b": (4, 256, 4, 16, (64, 128))}
SLICE_LAYERS = {"llama4-scout-17b-a16e": 2, "zamba2-7b": 21,
                "olmoe-1b-7b": 4, "rwkv6-7b": 16}
# the memory the parity gate's fp32 run needs beside its weights
# (parity_layers): the embedding's perturbation (two temporaries of its
# size, 6.2 GB for qwen3-32b's), one layer's fp32 draws (1.9 GB) and the
# prefill's activations
PARITY_HEADROOM = 10e9
# ticks in each slice's profiled window: 20 before qwen3-32b and
# mistral-nemo-12b came, whose 20-tick profiles (4702 and 2310 kernels a
# tick) took 35.2 and 14.7 s of the script's time limit on an H100 (the
# other five slices' 34 s together)
SLICE_PROFILE_TICKS = 8
# the mesh phase: olmo-1b's layers and steps in its train steps, its layers
# in the fp32 serving check, olmoe-1b-7b's layers and prefill batch, and
# how many of phase 5's olmo-1b requests the two ranks serve
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 4, 2
MESH_FP32_LAYERS = 2
MESH_MOE_LAYERS, MESH_MOE_BATCH = 2, (4, 512)
MESH_REQUESTS = 1
# phase 10's pod mesh (2, 1, 1): olmo-1b's layers in its serving checks,
# the fp32 prefill's batch and the ticks of each dtype; and a (2, 1) rank's
# peak on an H100 when the step gathered whole params and gradients
MESH_POD_LAYERS, MESH_POD_FP32, MESH_POD_TICKS = 2, (4, 512), 8
MESH_FSDP_WHOLE_PEAK_GB = 7.93
# phase 10 (2)'s train step on (1, 2), the loss over vocab shards:
# olmo-1b's layers
MESH_TP_TRAIN_LAYERS = 2
# phase 11: each family at full width and cut depth on a (1, 2) mesh (its
# layers), the fp32 prefill batch and ticks, and the phase's time budget
MESH_FAMILIES = {"rwkv6-7b": 2, "zamba2-7b": 6, "llama-3.2-vision-11b": 5,
                 "musicgen-large": 4}
MESH_FAMILY_FP32 = (4, 512)
MESH_FAMILY_TICKS = 16
MESH_FAMILIES_BUDGET_S = 120
# phase 12: decode states whose KV sequence shards over a (2, 1) mesh, each
# model at full width: its layers and batch; the buffer, the rows' first
# cache_len (row 0's writes cross the ranks' edge at KVSEQ_BUF / 2; the
# later rows give rank 1's shard a fifth to half of the softmax weight),
# the ticks and the phase's time budget
KVSEQ_RUNS = {"qwen3-8b": (2, 1), "zamba2-7b": (6, 1), "olmo-1b": (2, 4)}
KVSEQ_BUF, KVSEQ_TICKS = 32768, 16
KVSEQ_STARTS = (16376, 20480, 24576, 32000)
KVSEQ_BUDGET_S = 90
# phase 13: the dry-run's olmo-1b cells on a fake (1, 1) mesh, counted on
# fake CUDA and fake CPU tensors and run for real: phase 10's (1, 1) train
# step (MESH_TRAIN_LAYERS layers) and the uncut prefill of PREFILL_BATCH x
# PREFILL_LEN and tick of 4 slots of a DRYRUN_BUF buffer; the timed calls
# of each, the ticks, the peak's tolerance and the phase's time budget
DRYRUN_BUF, DRYRUN_CACHE_LENS = 2048, (100, 700, 1300, 2000)
DRYRUN_TIMED, DRYRUN_TICKS = 3, 2
DRYRUN_PEAK_TOL = 0.25
DRYRUN_BUDGET_S = 40
# phase 14: the examples, serve_batch at --full for these models (the
# reference's other flags: batch 4, prompts of 8, 12 new tokens), the fp32
# run's tokens against one forward (the gap to each row's argmax, over the
# row's range), then the sweep; the phase's time budget
EXAMPLE_ARCHS = ("olmo-1b", "zamba2-7b")
EXAMPLES_GAP = 1e-3
EXAMPLES_BUDGET_S = 30


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    """Mark a phase's start with the script's elapsed seconds."""
    log(f"== {name} at {time.perf_counter() - T0:.1f} s")


def no_drop(cfg):
    """An MoE config at capacity_factor E / k, where capacity is the call's
    T tokens and no choice drops; other configs as they are. A prefill of
    S tokens at the real capacity (1.25 k S / E slots an expert) drops
    choices that serving, 4 tokens a tick at capacity 4, keeps, so the two
    compute the same function only at this capacity (tests/test_torch_moe.py
    holds both)."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.launch import serve as L
    from repro_torch.serve import decode as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1. card ------------------------------------------------------------
    phase("1. card")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # -- 2. build -----------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    log(f"build: {len(logs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:   # the kernel and its template
                found = re.search(r"([A-Za-z_]+_kernel)(I\w+?E)?E", line)
                entry = found.group(1) + (found.group(2) or "") if found else ""
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  {name} {entry}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    phase("3. kernels")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush_buffer(dev)

    def time_ms(fn, iters, per_call=None):
        return flushed_ms(fn, iters, flush, per_call)

    def randn(shape, dtype, scale=1.0, g=None):
        return (torch.randn(shape, generator=g or gen, device=dev)
                * scale).to(dtype)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def compare(name, got, want, dtype, tol=TOL):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        rtol, atol = tol[dtype]
        ok = bool(torch.isfinite(got).all()) and \
            torch.allclose(got, want, rtol=rtol, atol=atol)
        log(f"  {name}: max_abs_err={err:.3e} (rtol=atol={atol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    def bound(flops, nbytes, dtype):
        t_ops = flops / PEAK_FLOPS[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    dtype_name = {v: k for k, v in dtypes.items()}

    def bshd_to_bhsd(*ts):
        return [t.permute(0, 2, 1, 3) for t in ts]

    def flash_times(q, k, v):
        """The kernel, its plain version and SDPA on (B, S, H, D) inputs,
        causal, beside the bound: query i sees i + 1 keys; q, k, v read
        once and o written once."""
        (b, s, h, d), kv = q.shape, k.shape[2]
        qh, kh, vh = bshd_to_bhsd(q, k, v)
        row = {
            "ms": time_ms(lambda: ops.flash_attention(q, k, v), 10),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(qh, kh, vh),
                                10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=h != kv), 10),
        }
        row["bound_ms"], row["bound_by"] = bound(
            *AT.KERNELS["flash_attention"].cost(
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": dtype_name[q.dtype]}), dtype_name[q.dtype])
        return row

    def decode_times(q, kc, vc, lens):
        """The kernel, its plain version and SDPA (a boolean mask at
        cache_len) on (B, 1, H, D) queries and (B, S, KV, D) caches,
        beside the bound: the cache positions this call reads (each row's
        cache_len) once, q read and o written once."""
        (b, _, h, d), (s, kv) = q.shape, kc.shape[1:3]
        kh, vh = bshd_to_bhsd(kc, vc)
        qh = q.permute(0, 2, 1, 3)                              # (B, H, 1, D)
        mask = (torch.arange(s, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        row = {
            "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 50),
            "plain_ms": time_ms(lambda: dec.decode_attention_plain(
                q[:, 0], kh, vh, lens), 50),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=h != kv), 50),
        }
        row["bound_ms"], row["bound_by"] = bound(
            *AT.KERNELS["decode_attention"].cost(
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": dtype_name[q.dtype]},
                valid=int(lens.clamp(max=s).sum())), dtype_name[q.dtype])
        return row

    log("kernels: flash attention against its plain version")
    qwen_flash, qwen_decode = {}, {}
    qgen = torch.Generator(device=dev).manual_seed(1)   # QWEN_*_CASES'
    for (b, s, h, kv, d, causal, dt), g in [
            *((case, gen) for case in FLASH_CASES),
            *((case, qgen) for case in QWEN_FLASH_CASES),
            ((PREFILL_BATCH, PREFILL_LEN, 16, 16, 128, True, "bfloat16"),
             gen)]:
        q = randn((b, s, h, d), dtypes[dt], g=g)
        k = randn((b, s, kv, d), dtypes[dt], g=g)
        v = randn((b, s, kv, d), dtypes[dt], g=g)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(*bshd_to_bhsd(q, k, v), causal=causal)
        flash_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} causal={causal} "
                            f"{dt}", got, want.permute(0, 2, 1, 3), dt)
        if (b, s, h, d) == (PREFILL_BATCH, PREFILL_LEN, 32, 112):
            zamba_flash = flash_times(q, k, v)        # zamba2-7b's prefill shape
        if (b, s, h, kv) == (PREFILL_BATCH, PREFILL_LEN, 40, 8):
            llama4_flash = flash_times(q, k, v)    # llama4-scout's prefill shape
        if (b, s, h, d, dt) == (PREFILL_BATCH, PREFILL_LEN, 32, 64,
                                "bfloat16"):
            musicgen_flash = flash_times(q, k, v)  # musicgen-large's
        if (b, s, h, kv) == (PREFILL_BATCH, PREFILL_LEN, 32, 8):
            vision_flash = flash_times(q, k, v)    # llama-3.2-vision-11b's
        if (b, s, h, kv) == (PREFILL_BATCH, PREFILL_LEN, 64, 8):
            qwen_flash[dt] = flash_times(q, k, v)  # qwen3-32b's, GQA 8:1
        del got, want
    for causal in (True, False):      # views of one (B, S, 3, H, D) buffer
        fused = randn((2, 300, 3, 4, 64), torch.bfloat16).unbind(2)
        want = fa.flash_attention_plain(
            *bshd_to_bhsd(*(t.contiguous() for t in fused)), causal=causal)
        compare(f"fused (B, S, 3, H, D) views b=2 s=300 h=4 d=64 "
                f"causal={causal} bfloat16",
                ops.flash_attention(*fused, causal=causal),
                want.permute(0, 2, 1, 3), "bfloat16")
    # the last case is olmo-1b's prefill shape: time it there
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "max_abs_err": flash_err, "tol": TOL["bfloat16"][1],
        **flash_times(q, k, v),
        "at_zamba2_7b": {"shape": [PREFILL_BATCH, PREFILL_LEN, 32, 32, 112],
                         **zamba_flash},
        "at_llama4_scout": {"shape": [PREFILL_BATCH, PREFILL_LEN, 40, 8, 128],
                            **llama4_flash},
        "at_musicgen_large": {"shape": [PREFILL_BATCH, PREFILL_LEN, 32, 32,
                                        64], **musicgen_flash},
        "at_llama_3_2_vision_11b": {
            "shape": [PREFILL_BATCH, PREFILL_LEN, 32, 8, 128], **vision_flash},
        **{f"at_qwen3_32b{'' if dt == 'bfloat16' else '_fp32'}": {
            "shape": [PREFILL_BATCH, PREFILL_LEN, 64, 8, 128], **row}
           for dt, row in qwen_flash.items()},
    }

    log("kernels: decode attention against its plain version")
    for b, s, h, kv, d, dt in DECODE_EDGE_CASES:
        q = randn((b, 1, h, d), dtypes[dt])
        kc, vc = randn((b, s, kv, d), dtypes[dt]), randn((b, s, kv, d), dtypes[dt])
        lens = torch.tensor([1, s, 0, s // 2 + 3][:b], dtype=torch.int32,
                            device=dev)
        compare(f"b={b} s={s} h={h} kv={kv} d={d} {dt} "
                f"cache_len={lens.tolist()}",
                ops.decode_attention(q, kc, vc, lens)[:, 0],
                dec.decode_attention_plain(q[:, 0], *bshd_to_bhsd(kc, vc),
                                           lens), dt)
    for (b, s, h, kv, d, dt), g in [
            *((case, gen) for case in DECODE_CASES),
            *((case, qgen) for case in QWEN_DECODE_CASES),
            ((*SLICES["olmo-1b"][:2], 16, 16, 128, "bfloat16"), gen)]:
        q = randn((b, 1, h, d), dtypes[dt], g=g)
        kc = randn((b, s, kv, d), dtypes[dt], g=g)
        vc = randn((b, s, kv, d), dtypes[dt], g=g)
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                             dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lens)
        want = dec.decode_attention_plain(q[:, 0], *bshd_to_bhsd(kc, vc), lens)
        decode_err = compare(f"b={b} s={s} h={h} kv={kv} d={d} {dt} "
                             f"cache_len={lens.tolist()}", got[:, 0], want, dt)
        if (b, s, h, kv) == (4, 256, 64, 8):
            qwen_decode[dt] = decode_times(q, kc, vc, lens)   # qwen3-32b's
    # the last case is olmo-1b's serving shape: one call is one kernel
    if kernel_count(lambda: ops.decode_attention(q, kc, vc, lens)) != 1:
        raise AssertionError("a decode attention call ran more than one "
                             "CUDA kernel")
    log("  one decode attention call: one CUDA kernel (profiler)")
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:24",
        "max_abs_err": decode_err, "tol": TOL["bfloat16"][1],
        **decode_times(q, kc, vc, lens),
        **{f"at_qwen3_32b{'' if dt == 'bfloat16' else '_fp32'}": {
            "shape": [4, 256, 64, 8, 128], **row}
           for dt, row in qwen_decode.items()},
    }
    del q, k, v, kc, vc, got, want

    def wkv6_inputs(b, s, h, k, dt, logw_lo=-7.0, logw_hi=-0.7, views=False):
        """tests/test_kernels.py's draws: r, k, v ~ 0.5 N(0, 1), logw =
        -exp(U(lo, hi)), u ~ 0.3 N(0, 1); logw and u fp32, as in the model.
        With ``views``, r, k and v are (B, S, H, K) views of one wider
        projection and logw a view of a wider buffer."""
        if views:
            wide = randn((b, s, 3 * h * k + 64), dtypes[dt], 0.5)
            r, kk, v = (wide[..., i * h * k:(i + 1) * h * k].unflatten(
                -1, (h, k)) for i in range(3))
            logw = -torch.exp(uniform((b, s, h * k + 8), logw_lo, logw_hi))
            logw = logw[..., :h * k].unflatten(-1, (h, k))
        else:
            r, kk, v = (randn((b, s, h, k), dtypes[dt], 0.5) for _ in range(3))
            logw = -torch.exp(uniform((b, s, h, k), logw_lo, logw_hi))
        return r, kk, v, logw, randn((h, k), torch.float32, 0.3)

    def bhsk(*ts):
        return [t.permute(0, 2, 1, 3) for t in ts]

    def wkv6_plain_bshk(r, kk, v, logw, u):
        return wkv.wkv6_plain(*bhsk(r, kk, v, logw), u).permute(0, 2, 1, 3)

    log("kernels: WKV6 against its plain version")
    rwkv = get_arch("rwkv6-7b")
    wkv_shape = (PREFILL_BATCH, PREFILL_LEN, rwkv.n_heads, rwkv.rwkv.head_dim)
    for b, s, h, k in WKV6_EDGE_CASES:
        args = wkv6_inputs(b, s, h, k, "bfloat16", views=True)
        compare(f"views b={b} s={s} h={h} k={k} bfloat16", ops.wkv6(*args),
                wkv6_plain_bshk(*args), "bfloat16", TOL_WKV6)
    args = wkv6_inputs(1, 64, 2, 64, "bfloat16")
    shifted = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16,
                          device=dev)[..., 1:65]      # base 2 bytes off 16
    try:
        ops.wkv6(shifted, *args[1:])
    except ValueError as err:
        log(f"  a misaligned bf16 view raises: {err}")
    else:
        raise AssertionError("the bf16 WKV6 kernel took a misaligned view")
    for b, s, h, k, dt in WKV6_CASES + [(*wkv_shape, "bfloat16")]:
        r, kk, v, logw, u = wkv6_inputs(b, s, h, k, dt)
        got = ops.wkv6(r, kk, v, logw, u)
        wkv_err = compare(f"b={b} s={s} h={h} k={k} {dt}", got,
                          wkv6_plain_bshk(r, kk, v, logw, u), dt, TOL_WKV6)
        del got
    rh, kh, vh, wh = bhsk(r, kk, v, logw)
    wkv_row = {
        "name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:24",
        "max_abs_err": wkv_err, "tol": TOL_WKV6["bfloat16"][1],
        "ms": time_ms(lambda: ops.wkv6(r, kk, v, logw, u), 10, per_call=1),
        "plain_ms": time_ms(lambda: wkv.wkv6_plain(rh, kh, vh, wh, u), 3),
        "library_ms": None,     # no single PyTorch call computes WKV6
    }
    log("  one bf16 WKV6 call: one CUDA kernel (profiler, in its timing)")
    wkv_row["bound_ms"], wkv_row["bound_by"] = bound(
        *AT.KERNELS["rwkv6"].cost(
            {"b": b, "s": s, "h": h, "k": k, "dtype": dt}), dt)
    for dt in ("float32", "bfloat16"):       # the scalar and chunked kernels
        r, kk, v, logw, u = wkv6_inputs(1, 512, 2, 64, dt,
                                        float(np.log(0.3)), float(np.log(3.0)))
        compare(f"strong decay, logw in (-3, -0.3), b=1 s=512 h=2 k=64 {dt}, "
                f"against the sequential wkv6_ref", ops.wkv6(r, kk, v, logw, u),
                ref.wkv6_ref(r, kk, v, logw, u), dt, TOL_WKV6)
    del r, kk, v, logw, u, rh, kh, vh, wh, args, shifted

    def ssd_inputs(b, s, h, p, g, n, dt, strong=False):
        """tests/test_kernels.py's draws (dt = softplus(N(0,1) - 1), A =
        -exp(0.3 N(0,1))), or with ``strong`` dt in (0.1, 0.5) and A in
        (-16, -1), so that dt A reaches -8 per token."""
        x = randn((b, s, h, p), dtypes[dt], 0.5)
        if strong:
            dtv = uniform((b, s, h), 0.1, 0.5)
            A = -uniform((h,), 1.0, 16.0)
        else:
            dtv = F.softplus(randn((b, s, h), torch.float32) - 1.0)
            A = -torch.exp(randn((h,), torch.float32, 0.3))
        Bm = randn((b, s, g, n), dtypes[dt], 0.5)
        Cm = randn((b, s, g, n), dtypes[dt], 0.5)
        return x, dtv, A, Bm, Cm, torch.ones(h, device=dev)

    def ssd_plain_bshd(x, dtv, A, Bm, Cm, Dv):
        return ssd.ssd_plain(x.permute(0, 2, 1, 3), dtv.permute(0, 2, 1), A,
                             Bm.permute(0, 2, 1, 3), Cm.permute(0, 2, 1, 3),
                             Dv).permute(0, 2, 1, 3)

    log("kernels: Mamba-2 SSD against its plain version")
    zamba = get_arch("zamba2-7b")
    mc = zamba.mamba
    ssd_shape = (PREFILL_BATCH, PREFILL_LEN, mc.n_heads(zamba.d_model),
                 mc.head_dim, mc.n_groups, mc.d_state)
    for b, s, h, p, g, n, dt in SSD_CASES + [(*ssd_shape, "bfloat16")]:
        args = ssd_inputs(b, s, h, p, g, n, dt)
        ssd_err = compare(f"b={b} s={s} h={h} p={p} g={g} n={n} {dt}",
                          ops.mamba2_ssd(*args), ssd_plain_bshd(*args), dt,
                          TOL_SSD)
    x, dtv, A, Bm, Cm, Dv = args
    ssd_row = {
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:24",
        "max_abs_err": ssd_err, "tol": TOL_SSD["bfloat16"][1],
        "ms": time_ms(lambda: ops.mamba2_ssd(*args), 10, per_call=1),
        "plain_ms": time_ms(lambda: ssd_plain_bshd(*args), 3),
        "library_ms": None,     # no single PyTorch call computes the SSD scan
    }
    log("  one bf16 SSD call: one CUDA kernel (profiler, in its timing)")
    ssd_row["bound_ms"], ssd_row["bound_by"] = bound(
        *AT.KERNELS["mamba2_ssd"].cost(
            {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "dtype": dt}), dt)
    for dt in ("float32", "bfloat16"):       # the scalar and chunked kernels
        args = ssd_inputs(1, 512, 4, 64, 1, 64, dt, strong=True)
        compare(f"strong decay, dt A in (-8, -0.1), b=1 s=512 h=4 p=64 n=64 "
                f"{dt}, against the sequential ssd_ref",
                ops.mamba2_ssd(*args), ref.ssd_ref(*args), dt, TOL_SSD)
    del x, dtv, A, Bm, Cm, Dv, args
    rows = (flash_row, decode_row, wkv_row, ssd_row)
    for name, row in [(r["name"], r) for r in rows] + [
            ("flash_attention at zamba2-7b's shape", zamba_flash),
            ("flash_attention at llama4-scout's shape", llama4_flash),
            ("flash_attention at musicgen-large's shape", musicgen_flash),
            ("flash_attention at llama-3.2-vision-11b's shape",
             vision_flash),
            *[(f"{name} at qwen3-32b's shape, {dt}", times)
              for name, rows in (("flash_attention", qwen_flash),
                                 ("decode_attention", qwen_decode))
              for dt, times in rows.items()]]:
        lib = "null" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"  {name}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
    del flush
    torch.cuda.empty_cache()
    at_ranks = mesh_kernel_times(dev)
    at_rank = at_ranks["kernels_at_8_heads"]
    flash_row["at_olmo_1b_8_of_16_heads"] = at_rank["flash"]
    decode_row["at_olmo_1b_8_of_16_heads"] = at_rank["decode"]
    log("kernels: flash and decode at a rank's share of olmo-1b's heads "
        f"(8 of 16; phase 10): {json.dumps(at_rank)} [{card}]")
    for arch, got in at_ranks["kernels_at_family_ranks"].items():
        key = f"at_{arch.replace('-', '_').replace('.', '_')}_rank"
        flash_row[key], decode_row[key] = got["flash"], got["decode"]
    log("kernels: flash (bf16 prefill) and decode (fp32 ticks) at a rank's "
        "share of the heads of phase 11's attention models: "
        f"{json.dumps(at_ranks['kernels_at_family_ranks'])} [{card}]")
    shards = kvseq_kernel_times(dev)
    decode_row.update(shards)
    log("kernels: decode attention with return_lse at a rank's shard of "
        f"{KVSEQ_BUF // 2} positions, and without at the whole "
        f"{KVSEQ_BUF} (phase 12): {json.dumps(shards)} [{card}]")
    scans = scan_kernel_times(dev)
    wkv_row["at_rwkv6_7b_32_of_64_heads"] = scans["wkv6"]
    ssd_row["at_zamba2_7b_56_of_112_heads"] = scans["mamba2_ssd"]
    log("kernels: WKV6 and SSD at a rank's share of rwkv6-7b's and "
        f"zamba2-7b's heads (32 of 64, 56 of 112; phase 11): "
        f"{json.dumps(scans)} [{card}]")
    phase("3. kernels: autotune")
    run_autotune(card, dev)
    free()

    # -- 4. small reference: the card's kernels against the CPU's plain path
    phase("4. reference")
    log("reference: reduced configs, card against CPU, fp32")
    for arch in ("olmo-1b", "qwen3-8b", "rwkv6-7b", "zamba2-7b",
                 "olmoe-1b-7b", "llama4-scout-17b-a16e", "mistral-nemo-12b"):
        check_reduced(get_arch(arch).reduced(), dev)
    # .reduced() keeps 4 query heads on 1 kv head (qwen3-32b's is
    # qwen3-8b's, above): the dense pair's GQA 8:1 at 16 on 2 kv heads
    for arch in ("qwen3-32b", "mistral-nemo-12b"):
        check_reduced(dataclasses.replace(get_arch(arch).reduced(),
                                          **REDUCED_GQA8), dev)

    log("reference: full width at reduced depth, fp32, prefill against "
        "serving on the card (MoE at the no-drop capacity)")
    for arch, layers in (("olmo-1b", 2), ("rwkv6-7b", 2), ("zamba2-7b", 7),
                         ("olmoe-1b-7b", 2), ("qwen3-32b", 2),
                         ("mistral-nemo-12b", 2)):
        cfg = no_drop(dataclasses.replace(get_arch(arch), n_layers=layers))
        params = weights(cfg, dev)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 37)]
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32)
        served = L.serve(cfg, params, prompts, slots=2, buf=128, max_new=1,
                         compute_dtype=torch.float32).first_logits
        for prompt, got in zip(prompts, served):
            want = pre(params, {"tokens": torch.tensor([prompt])})[0].cpu()
            err = (got - want).abs().max().item()
            limit = 1e-3 * want.abs().max().item()
            log(f"  {arch}, {layers} layers, prompt of {len(prompt)}: "
                f"max_abs_err={err:.3e} (limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"{arch}: fp32 prefill and serving "
                                     f"disagree at full width")
        del params
        free()

    # -- 5. the slices at full width -----------------------------------------
    # seven models one after the other (run_model_slice), each freed before
    # the next; qwen3-32b (64 of 64 layers: 64 flash launches a prefill
    # call, 64 decode a tick) and mistral-nemo-12b (40 of 40: 40 and 40)
    # (every slice's weights made in bf16 a layer at a time); qwen3-32b's
    # parity gate takes its bf16 rounding from a cut of the model to the
    # layers whose fp32 tree fits (parity_layers)
    counters = launch_counters()
    totals = dict.fromkeys(counters, 0)
    for arch, shape in SLICES.items():
        phase(f"5. slice {arch}")
        counts = run_model_slice(get_arch(arch), shape, card, counters, dev)
        for name, n in counts.items():
            totals[name] += n

    # -- 6. training -----------------------------------------------------------
    phase("6. train")
    check_train_parity(card, dev)
    log("train: " + json.dumps(run_train(card, counters, dev)))
    free()
    check_family_train_parity(card, dev)
    free()
    for arch in TRAIN_FAMILIES:
        log("train: " + json.dumps(run_train_family(card, counters, dev,
                                                    arch)))
        free()

    # -- 7. checkpoints and supervision ----------------------------------------
    phase("7. checkpoints")
    log("checkpoint: " + json.dumps(run_checkpoints(card, counters, dev)))
    free()

    # -- 8. the platform on the card -------------------------------------------
    phase("8. platform")
    engine = run_platform(card, counters, dev)
    for name, n in engine["launches"].items():
        totals[name] += n
    log("engine: " + json.dumps(engine))
    free()

    # -- 9. the durable control plane and the subprocess runner ----------------
    phase("9. durable")
    durable = run_durable(card)
    for name, n in durable["launches"].items():
        totals[name] += n
    log("durable: " + json.dumps(durable))
    free()

    # -- 10. the sharded steps on a mesh ---------------------------------------
    phase("10. mesh")
    mesh = run_mesh(card, dev, at_rank)
    for rank in mesh["ranks"] + mesh["fsdp"]:
        for name, n in rank["launches"].items():
            totals[name] += n
    log("mesh: " + json.dumps(mesh))

    # -- 11. the recurrent, hybrid, VLM and audio layouts on a mesh -----------
    phase("11. mesh families")
    families = run_mesh_families(card, dev)
    for rank in families["ranks"]:
        for name, n in rank["launches"].items():
            totals[name] += n
    log("mesh_families: " + json.dumps(families))

    # -- 12. decode states whose KV sequence shards over the mesh -------------
    phase("12. kvseq")
    kvseq = run_kvseq(card, dev)
    for rank in kvseq["ranks"]:
        for name, n in rank["launches"].items():
            totals[name] += n
    log("kvseq: " + json.dumps(kvseq))

    # -- 13. the dry-run: counted cells against the same steps run ----------
    phase("13. dryrun")
    dry = run_dryrun(card, dev)
    for name, n in dry["launches"].items():
        totals[name] += n
    log("dryrun: " + json.dumps(dry))

    # -- 14. the paper's serving and sweep workflows as the port's examples --
    phase("14. examples")
    examples = run_examples(card, counters, dev)
    for name, n in examples["launches"].items():
        totals[name] += n
    log("examples: " + json.dumps(examples))

    for row in rows:
        row["launches"] = totals[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    phase("end")
    print(json.dumps({"kernels": [
        {k: row[k] for k in keys + tuple(sorted(set(row) - set(keys)))}
        for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_autotune(card, dev) -> None:
    """Phase 3's autotune step (see the module docstring): each bf16
    chunked instance's registers, spills, shared memory and CTAs per SM;
    every rung of each kernel's knob at its first serving shape against
    the fp32 plain version, flash's group bit-equal to its default; then
    ``autotune_all`` at the serving shapes into a cache under build/, one
    ``autotune:`` line an entry. Its launches are put back on the
    counters, so no main-path count holds them."""
    import torch

    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    t0 = time.perf_counter()
    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    for name, info in (("rwkv6 value_tile", wkv.chunk_kernel_info),
                       ("mamba2_ssd state_tile", ssd.chunk_kernel_info)):
        for tile in (32, 64):
            log(f"autotune: {name} {tile}: "
                f"{json.dumps(info(tile, dev))} [{card}]")
    for kernel, shapes in AT.SERVING_SHAPES.items():
        spec, shape = AT.KERNELS[kernel], shapes[0]
        args, want = spec.build(shape, 0, dev)
        (knob, ladder), = AT.ladders_of(spec, shape).items()
        default = AT.seed_config(spec, shape)
        base = spec.call(default, *args)
        measure = AT.default_measure(spec, args, dev)
        for value in ladder:
            got = spec.call({knob: value}, *args)
            torch.cuda.synchronize()
            err = AT.output_err(got, want)
            same = _bits_equal(got, base)
            diff = (got.float() - base.float()).abs().max().item()
            us = measure({knob: value}) * 1e6
            log(f"  {kernel} {AT.shape_key(shape)} {knob}={value}: "
                f"{us:.2f} us, max_err={err:.3e} (tol {spec.tol}), "
                f"bit-equal to {knob}={default[knob]}: {same} (max |diff| "
                f"{diff:.3e})")
            if not err <= spec.tol:
                raise AssertionError(f"{kernel} at {knob}={value} disagrees "
                                     f"with its plain version")
            if kernel == "flash_attention" and not same:
                raise AssertionError(f"flash attention's group {value} "
                                     f"changed the output's bits")
            del got
        del args, want, base, measure
        free()
    cache = AT.TuningCache(str(ROOT / "build" / "autotune_cache.json"))
    for entry in AT.autotune_all(device=dev, shapes=AT.SERVING_SHAPES,
                                 cache=cache):
        log("autotune: " + json.dumps({**entry, "card": card}))
    cache.save()
    launched = {}
    for name, fn in counters.items():
        launched[name] = fn.launches - before[name]
        fn.launches = before[name]
    log(f"autotune: {time.perf_counter() - t0:.1f} s, launches (not the "
        f"main path's) {json.dumps(launched)}; cache {cache.path}")


def launch_counters() -> dict:
    """The kernels' wrappers by name: each counts its launches in
    ``launches``."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import wkv6 as wkv
    return {"flash_attention": fa.flash_attention_bhsd,
            "decode_attention": dec.decode_attention_bhd,
            "wkv6": wkv.wkv6_bhsk, "mamba2_ssd": ssd.ssd_bhsp}


def weights(cfg, dev, dtype=None):
    """Weights from seed 0 on the card, fp32 or ``dtype`` (``init_params``
    makes them in it a layer at a time, the same values each call whatever
    the dtype); RWKV's zero-init leaves and the VLM's gates seeded
    (_enliven)."""
    import torch

    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, device=dev, dtype=dtype or torch.float32)
    if cfg.family in ("ssm", "vlm"):
        _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
    return params


def free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check_reduced(cfg, dev) -> None:
    """A reduced config (its zero-init leaves seeded where the card's gates
    need them, see _enliven) on the card (kernels) against the CPU (plain
    versions), fp32: prefill logits on 2 rows of 37 tokens, and decode
    logits after 6 tokens, within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D
    cpu_params = M.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":        # gates at zero would ignore vision
        _enliven(cfg, cpu_params, torch.Generator().manual_seed(1))
    card_params = _to(cpu_params, dev)
    batch = model_batch(cfg, np.random.default_rng(1), 2, 37)
    toks = batch["tokens"]
    errs = []
    for params, where in ((cpu_params, torch.device("cpu")),
                          (card_params, dev)):
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                                  device=where)
        errs.append(pre(params, batch).cpu())
        step = D.make_serve_step(cfg, 40, compute_dtype=torch.float32,
                                 device=where)
        states = T.init_decode_state(cfg, 2, 40, dtype=torch.float32,
                                     device=where, vision=batch.get("vision"),
                                     params=params)
        for t in range(6):
            logits, states, _ = step(params, states, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((2,), t, dtype=torch.int32)})
        errs.append(logits.cpu())
    pre_err = (errs[0] - errs[2]).abs().max().item()
    dec_err = (errs[1] - errs[3]).abs().max().item()
    log(f"  {cfg.name}: prefill logits max_abs_err={pre_err:.3e}, decode "
        f"logits max_abs_err={dec_err:.3e} (tol 1e-4)")
    if not max(pre_err, dec_err) <= 1e-4:
        raise AssertionError(f"{cfg.name}: card disagrees with the CPU")


def _enliven_rwkv(cfg, params, gen) -> None:
    """Give the leaves the reference initialises to zero (bonus u, the
    shift and decay LoRAs' second factors) small seeded values, and the
    decay base RWKV-6's own initial spread over channels n and layers l,
    -6 + 5 (n / (D - 1)) ** (0.7 + 1.3 l / (L - 1)) (l / (L - 1) = 0 for
    one layer), so that u and the data-dependent decay take part in the
    run."""
    import torch
    tm = params["layers"]["tm"]
    for key, scale in (("bonus_u", 0.1), ("shift_lora_b", 0.01),
                       ("decay_lora_b", 0.01)):
        tm[key] = (scale * torch.randn(tm[key].shape, generator=gen,
                                       device=gen.device)).to(tm[key].dtype)
    d, n_l = cfg.d_model, cfg.n_layers
    ch = torch.arange(d, device=gen.device) / (d - 1)
    layer = torch.arange(n_l, device=gen.device)[:, None] / max(n_l - 1, 1)
    tm["decay_base"] = -6.0 + 5.0 * ch[None, :] ** (0.7 + 1.3 * layer)


def _enliven(cfg, params, gen) -> None:
    """Seed every leaf the reference initialises to zero, in the leaf's
    dtype (the values of a tree seeded in fp32 and then cast): RWKV's as
    _enliven_rwkv does, the hybrid's Mamba-2 conv biases (0.1 N(0, 1)), the
    VLM's cross-attention gates (uniform in [0.5, 1.5]: at zero every
    cross-attention layer adds nothing, and the logits ignore the vision
    states). The dense, MoE and audio families have none."""
    import torch
    if cfg.family == "ssm":
        _enliven_rwkv(cfg, params, gen)
        return
    if cfg.family == "vlm":
        single = params["layers"]["single"]
        for key in ("gate_attn", "gate_mlp"):
            single[key] = 0.5 + torch.rand(single[key].shape, generator=gen,
                                           device=gen.device)
        return
    if cfg.family != "hybrid":
        return
    for part in ("inner", "trailing"):
        m = params["layers"][part]["m"]
        for key in ("conv_b_x", "conv_b_BC"):
            m[key] = (0.1 * torch.randn(m[key].shape, generator=gen,
                                        device=gen.device)).to(m[key].dtype)


def _moe_drops(cfg, params, tokens) -> int:
    """Choices that the first layer's MoE block drops at capacity in a
    forward of ``tokens`` (fp32, on the params' device): the layer's input
    to the block (embedding, attention, the two norms, as
    ``transformer.layer_fwd`` runs them), then each expert's choices by the
    block's own routing (``top_k_lower_first`` on the router's softmax)
    less its capacity (``moe_capacity`` over all B * S tokens)."""
    import torch

    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map
    lp = tree_map(lambda a: a[0], params["layers"])
    ctx = M.make_ctx(cfg, tokens.shape[1], "prefill",
                     compute_dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        x = M.embed_tokens(params, tokens, cfg, torch.float32)
        x = x + B.attention_block(lp["attn"], B.apply_norm(lp["ln1"], x, cfg),
                                  cfg, rope=ctx["rope"])[0]
        h = B.apply_norm(lp["ln2"], x, cfg).reshape(-1, cfg.d_model)
        probs = torch.softmax(h @ lp["moe"]["router"], -1)
        idx = B.top_k_lower_first(probs, cfg.moe.top_k)[1]
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    cap = B.moe_capacity(cfg, h.shape[0])
    return int((counts - cap).clamp_min(0).sum())


def model_batch(cfg, rng, b: int, s: int) -> dict:
    """A request batch on the host: tokens (B, S), or (B, S, K) frames of
    codes with codebooks, from ``rng``, and the VLM's vision states (B, Nv,
    d_src) ~ N(0, 1) in fp32, as the data pipeline draws them."""
    import torch
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     shape))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype("float32"))
    return batch


def launches_per_call(cfg) -> tuple[dict, dict]:
    """Kernel launches of one prefill call and of one decode tick, from the
    model's layout: every layer runs its block's kernel once (the VLM's
    cross-attention layers run none: their attention is plain torch)."""
    from repro_torch.models import transformer as T
    lay = T.build_layout(cfg)
    if lay["kind"] == "uniform" and lay["block"] in ("dense", "moe"):
        return {"flash_attention": lay["n"]}, {"decode_attention": lay["n"]}
    if lay["kind"] == "uniform" and lay["block"] == "rwkv":
        return {"wkv6": lay["n"]}, {}
    inner = lay["periods"] * lay["inner_n"] + lay["trailing"]
    if lay["single_block"] == "cross_attn":
        return {"flash_attention": inner}, {"decode_attention": inner}
    return ({"mamba2_ssd": inner, "flash_attention": lay["periods"]},
            {"decode_attention": lay["periods"]})


def run_slice(cfg, params, card, counters, shape):
    """One model's main path in bf16: prefill, serving, and each request's
    prompt through the prefill step, with the launch counters zeroed before
    and checked after. Returns the launch counts, each request's prompt as
    a batch of one row, and each request's prefill and served logits at
    its last prompt token. The
    timed prefills and the serving run the config as it is; an MoE
    config's per-request prefills run at the no-drop capacity (no_drop),
    the function serving computes, for the parity gate. An MoE slice also
    profiles one prefill call and reports its MoE blocks' device time."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as L
    from repro_torch.serve import decode as D

    slots, buf, requests, max_new, prompt_lens = shape
    per_call, per_tick = launches_per_call(cfg)

    def check(what, calls, ticks):
        got = {k: c.launches for k, c in counters.items()}
        want = {k: calls * per_call.get(k, 0) + ticks * per_tick.get(k, 0)
                for k in counters}
        if got != want:
            raise AssertionError(f"{cfg.name} {what}: launches {got}, "
                                 f"expected {want}")
        return got

    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0

    prefill = D.make_prefill_step(cfg)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)))
    prefill_s = []
    for _ in range(3):                    # the first call warms up
        t0 = time.perf_counter()
        out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    if out.shape != (PREFILL_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prefill gave {tuple(out.shape)} or non-finite")
    check("prefill", 3, 0)

    prompts = [rng.integers(0, cfg.vocab_size,
                            rng.integers(prompt_lens[0], prompt_lens[1] + 1)
                            ).tolist() for _ in range(requests)]
    res = L.serve(cfg, params, prompts, slots=slots, buf=buf, max_new=max_new)
    check(f"serve ({res.ticks} ticks)", 3, res.ticks)
    if any(len(o) != max_new or min(o) < 0 or max(o) >= cfg.vocab_size
           for o in res.outputs):
        raise AssertionError("served outputs of the wrong length or range")

    parity_prefill = D.make_prefill_step(no_drop(cfg))
    pre16 = [parity_prefill(params, {"tokens": torch.tensor([p])})[0]
             .float().cpu() for p in prompts]
    torch.cuda.synchronize()
    launches = check("main path", 3 + requests, res.ticks)
    if not all(bool(torch.isfinite(t).all()) for t in pre16 + res.first_logits):
        raise AssertionError(f"{cfg.name}: non-finite prefill or served "
                             "logits")

    fed = sum(len(p) + max_new - 1 for p in prompts)
    numbers = {
        "arch": cfg.name, "card": card,
        "prefill_ms": 1e3 * sum(prefill_s[1:]) / len(prefill_s[1:]),
        "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
        "slots": slots, "buffer": buf, "requests": requests,
        "max_new": max_new, "decode_ticks": res.ticks,
        "ms_per_tick": 1e3 * res.seconds / res.ticks,
        "generated_tokens_per_s": requests * max_new / res.seconds,
        "fed_tokens_per_s": fed / res.seconds,
        "serve_s": res.seconds,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    log("slice: " + json.dumps(numbers))
    log("profile: " + json.dumps(profile_ticks(cfg, params, card, slots, buf,
                                               SLICE_PROFILE_TICKS)))
    if cfg.moe is not None:
        log("profile: " + json.dumps(profile_prefill(
            cfg, params, card, lambda: prefill(params, {"tokens": tokens}))))
    return launches, [{"tokens": torch.tensor([p])} for p in prompts], \
        pre16, res.first_logits


def run_model_slice(full, shape, card, counters, dev) -> dict:
    """Phase 5 for one model of SLICES (``full``: its config): its bf16
    weights, made a layer at a time and cut to SLICE_LAYERS, through
    run_slice, then freed; then the parity gate on fp32 weights of the
    same draws (on a cut to parity_layers, where the fp32 tree does not
    fit). Returns the main path's launch counts."""
    import torch

    from repro_torch.serve import decode as D
    arch = full.name
    cfg = dataclasses.replace(full, n_layers=SLICE_LAYERS.get(
        arch, full.n_layers))
    t0 = time.perf_counter()
    params = weights(cfg, dev, torch.bfloat16)
    free()
    moe = "" if cfg.moe is None else (
        f"; {cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert}, top "
        f"{cfg.moe.top_k}, {cfg.moe.n_shared_experts} shared")
    log(f"slice: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim} on {cfg.n_kv_heads} kv heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}{moe}; weights in "
        f"{time.perf_counter() - t0:.2f} s")
    counts, batches, pre16, served16 = run_slice(cfg, params, card,
                                                 counters, shape)
    del params
    free()
    cut16 = None
    layers = parity_layers(cfg)
    if layers < cfg.n_layers:             # the fp32 tree does not fit
        cfg = dataclasses.replace(cfg, n_layers=layers)
        params = weights(cfg, dev, torch.bfloat16)
        pre = D.make_prefill_step(cfg)
        cut16 = [pre(params, b)[0].float().cpu() for b in batches]
        del params, pre
        free()
    params = weights(cfg, dev)            # fp32, after the counts are read
    log("parity: " + json.dumps(check_parity(
        no_drop(cfg), params, batches, pre16, served16, card, cut16)))
    del params
    free()
    return counts


def parity_layers(cfg) -> int:
    """The most layers of ``cfg`` whose fp32 tree fits the card's free
    memory with PARITY_HEADROOM to spare: all of them where the whole tree
    fits, else a cut of a uniform stack (its bytes grow by one layer's a
    layer). Raises where not even one layer fits."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    def nbytes(n):
        def total(tree):
            return sum(total(v) if isinstance(v, dict) else 4 * v.numel()
                       for v in tree.values())
        return total(M.param_shapes(dataclasses.replace(cfg, n_layers=n)))

    room = torch.cuda.mem_get_info()[0] - PARITY_HEADROOM
    if nbytes(cfg.n_layers) <= room:
        return cfg.n_layers
    one = nbytes(1)
    layers = int((room - one) // (nbytes(2) - one)) + 1
    if layers < 1 or T.build_layout(cfg)["kind"] != "uniform":
        raise AssertionError(f"{cfg.name}: no cut of its fp32 tree fits "
                             f"{room / 1e9:.1f} GB")
    return layers


def check_parity(cfg, params, batches, pre16, served16, card,
                 cut16=None) -> dict:
    """bf16 prefill (the prefill kernels) against bf16 serving (the decode
    path, token by token) at each request's last prompt token; ``batches``
    hold the requests' prompts (and vision states), row by row in the
    order of pre16 and served16.

    ``cut16``: for a model whose fp32 tree does not fit the card
    (parity_layers: qwen3-32b), ``cfg`` and ``params`` are the slice's
    model cut to fewer layers (its embedding, head and first layers) and
    cut16 that
    cut's bf16 prefill logits of the same requests: the rounding error
    below is the cut's, an estimate under the whole model's, since
    rounding grows with depth (the bound it gives is the tighter).

    ``params`` are the fp32 weights (their embeddings are changed in place
    at the end): each prompt's fp32 prefill measures the
    model's own bf16 rounding error, the largest distance of a bf16 prefill
    from its fp32 prefill over the requests. Two bf16 runs that round at
    different places agree only as well as that error lets them, so the
    bound is 5e-2 of the logits' range, as in the CPU tests, or twice the
    rounding error where that is larger. At random init a deep model can
    amplify rounding; to show how much, the fp32 prefill is run again with
    the embeddings scaled by 1 + 1e-6 N(0, 1), and the largest change of the
    logits is reported (not gated). That the two paths compute the same
    function is held in fp32, at full width and reduced depth, in the
    reference phase.

    An MoE request beyond the bound passes only where a router near-tie
    at its last prompt token explains it (router_near_tie): the two bf16
    paths chose different experts there, each such choice within twice
    the bf16 error of a tie in fp32, and with serving's choice forced the
    prefill agrees with the served logits within the bound."""
    import torch

    from repro_torch.serve import decode as D

    start = time.perf_counter()
    pre = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                              device=params["embed"].device)

    def fp32_rows():
        return [row for b in batches for row in pre(params, b).float().cpu()]

    pre32 = fp32_rows()
    rounding = [(p16 - p32).abs().max().item()
                for p16, p32 in zip(pre16 if cut16 is None else cut16,
                                    pre32)]
    errs = [(p - s).abs().max().item() for p, s in zip(pre16, served16)]
    of_range = [5e-2 * p.abs().max().item() for p in pre16]
    limits = [max(o, 2 * max(rounding)) for o in of_range]
    near_ties = {r: router_near_tie(cfg, params, batches[r], served16[r],
                                    limits[r])
                 for r in range(len(pre16))
                 if cfg.moe is not None and not errs[r] <= limits[r]}
    gen = torch.Generator(device=params["embed"].device).manual_seed(3)
    params["embed"].mul_(1 + 1e-6 * torch.randn(
        params["embed"].shape, generator=gen, device=gen.device))
    moved = [(p - p32).abs().max().item()
             for p, p32 in zip(fp32_rows(), pre32)]
    out = {"arch": cfg.name, "card": card,
           "rounding_layers": cfg.n_layers,
           "rounding_on": "a cut" if cut16 is not None else "the slice",
           "bf16_rounding_error": max(rounding),
           "fp32_change_for_1e-6_embedding_change": max(moved),
           "requests": [],
           "fields": ["bf16_max_abs_err", "limit", "bound",
                      "bf16_prefill_vs_fp32_prefill", "argmax_agree",
                      "router_near_tie"]}
    for r in range(len(pre32)):
        err, limit = errs[r], limits[r]
        bound = "5e-2 of the range" if of_range[r] >= 2 * max(rounding) \
            else f"2x the bf16 rounding at {cfg.n_layers} layers"
        tie = near_ties.get(r)
        out["requests"].append([err, limit, bound, rounding[r],
                                int(torch.equal(pre16[r].argmax(-1),
                                                served16[r].argmax(-1))),
                                tie])
        if not (err <= limit or tie and tie["explained"]):
            raise AssertionError(f"{cfg.name} request {r}: bf16 prefill and "
                                 f"serve logits differ by {err:.3e} > "
                                 f"{limit:.3e}" + (
                                     f"; {json.dumps(tie)}" if tie else ""))
    out["seconds"] = time.perf_counter() - start
    return out


def router_near_tie(cfg, params, batch, served, limit) -> dict:
    """Whether a router near-tie at an MoE request's last prompt token
    explains a bf16 prefill/serve disagreement beyond ``limit``.

    ``params`` are fp32 (the bf16 tree is their cast, the slice's weights
    bit for bit), ``batch`` the request's prompt as one row, ``served``
    its served logits. The request is replayed alone through the bf16
    serve step, a token a step (the decode path; its logits must stand
    for the served run: within ``limit`` of them), and prefilled in bf16
    and fp32, each MoE layer's routing probabilities at the last token
    recorded (``blocks.top_k_lower_first`` wrapped for the call). It is
    explained when the replay's top-k set differs from the bf16 prefill's
    in some layer, each such layer's fp32 margin (the k-th less the
    (k+1)-th probability) is at most twice the larger of the two bf16
    paths' probability errors there, and the bf16 prefill with the
    replay's choices forced at those layers agrees with ``served`` within
    ``limit``."""
    import torch

    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in tree.items()}

    dev = params["embed"].device
    params16 = M.cast_params(copy(params), torch.bfloat16)
    top_k, k = B.top_k_lower_first, cfg.moe.top_k
    seen, force = [], {}

    def routed(x, k):
        seen.append(x[-1].float().cpu())     # the last token's row
        vals, idx = top_k(x, k)
        if len(seen) - 1 in force:
            idx = idx.clone()
            idx[-1] = force[len(seen) - 1].to(idx.device)
            vals = vals.clone()
            vals[-1] = x[-1, idx[-1]]
        return vals, idx

    def run(fn, forced=None):
        seen.clear()
        force.clear()
        force.update(forced or {})
        return fn(), list(seen)

    toks = batch["tokens"].to(dev)
    n = toks.shape[1]
    prefill16 = D.make_prefill_step(cfg, device=dev)
    prefill32 = D.make_prefill_step(cfg, compute_dtype=torch.float32,
                                    device=dev)
    step = D.make_serve_step(cfg, n, device=dev)

    def replay():
        states = T.init_decode_state(cfg, 1, n, device=dev, params=params16)
        for t in range(n):
            logits, states, _ = step(params16, states, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((1,), t, dtype=torch.int32)})
        return logits[0].float().cpu()

    B.top_k_lower_first = routed
    try:
        pre, r16 = run(lambda: prefill16(params16, batch)[0].float().cpu())
        _, r32 = run(lambda: prefill32(params, batch)[0])
        rep, rd = run(replay)
        rd = rd[-len(r16):]                  # the last step's layers
        flips, forced = [], {}
        for layer, (a, b, f) in enumerate(zip(r16, rd, r32)):
            ia, ib = top_k(a, k)[1], top_k(b, k)[1]
            if torch.equal(ia.sort().values, ib.sort().values):
                continue
            srt = f.sort(descending=True).values
            flips.append({"layer": layer,
                          "fp32_margin": (srt[k - 1] - srt[k]).item(),
                          "bf16_err": max((a - f).abs().max().item(),
                                          (b - f).abs().max().item())})
            forced[layer] = ib
        with_forced, _ = run(
            lambda: prefill16(params16, batch)[0].float().cpu(), forced)
    finally:
        B.top_k_lower_first = top_k
    out = {"replay_vs_served": (rep - served).abs().max().item(),
           "prefill_vs_served": (pre - served).abs().max().item(),
           "forced_vs_served": (with_forced - served).abs().max().item(),
           "flips": flips}
    out["explained"] = bool(flips) and \
        all(f["fp32_margin"] <= 2 * f["bf16_err"] for f in flips) and \
        out["replay_vs_served"] <= limit and out["forced_vs_served"] <= limit
    return out


def _worst(got, want) -> float:
    """Largest over leaves of max|got - want| / max|want| (nested dicts)."""
    from repro_torch import convert
    got, want = convert.flatten(got), convert.flatten(want)
    return max(((got[k].float().cpu() - w.float().cpu()).abs().max()
                / w.abs().max().clamp_min(1e-30)).item()
               for k, w in want.items() if w.numel())


def check_train_parity(card, dev) -> None:
    """The train path at full width and reduced depth, fp32 (TF32 off).

    olmo-1b with 2 layers: one train step (its gradients, then the AdamW
    update) on the card against the same step on the CPU, at 2x256 (full
    attention) and 1x1536 (chunked). Gates: loss within 1e-4 relative;
    every gradient leaf within 1e-4 of its largest entry (fp32 sums in other
    orders); params within 2 lr (AdamW's first step is about lr * sign(g),
    and a gradient near zero may change sign). Then, on the card alone,
    olmo-1b and qwen3-8b with 2 layers at 1x1536: remat none, full and dots
    give gradients within 1e-6 of each leaf's largest entry, and the
    chunked attention's output and gradients (q, k, v before the GQA
    expansion) match the full attention's within 1e-4 of their largest
    entry at S = 1536."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)

    tc = T.TrainConfig(remat="full", compute_dtype="float32")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    init = M.init_params(cfg, 0, device="cpu")
    log(f"train: {cfg.name} at full width, 2 layers, fp32: one step on the "
        f"card against the CPU [{card}]")
    for b, s in ((2, 256), (1, 1536)):
        batch = TokenPipeline(DataConfig(vocab_size=64, seq_len=s,
                                         global_batch=b), cfg).batch_at(0)
        out = []
        for where in (torch.device("cpu"), dev):
            params = _to(init, where)
            t0 = time.perf_counter()
            loss, _, grads = T.make_grad_fn(cfg, tc, device=where)(
                params, {k: torch.as_tensor(v, device=where)
                         for k, v in batch.items()})
            adamw_update(oc, params, grads, T.make_opt_state(params, tc))
            loss = float(loss)
            out.append((loss, grads, params, time.perf_counter() - t0))
        (cl, cg, cp, cs), (gl, gg, gp, gs) = out
        loss_err, grad_err = abs(gl - cl) / abs(cl), _worst(gg, cg)
        param_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(leaves(gp), leaves(cp)) if b.numel())
        log(f"  {b}x{s}: loss {gl:.6f} (CPU {cl:.6f}, rel err {loss_err:.2e},"
            f" gate 1e-4), grads worst {grad_err:.2e} of the leaf max (gate "
            f"1e-4), params max_abs_err {param_err:.2e} (gate {2 * oc.lr:g}); "
            f"CPU {cs:.1f} s")
        if not (loss_err <= 1e-4 and grad_err <= 1e-4
                and param_err <= 2 * oc.lr):
            raise AssertionError(f"train step {b}x{s}: card and CPU disagree")
        del out, gg, cg, gp, cp

    rng = np.random.default_rng(5)
    for arch in ("olmo-1b", "qwen3-8b"):
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        params = M.init_params(cfg, 0, device=dev)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1536)),
                                    device=dev) for k in ("tokens", "labels")}
        check_remat(cfg, params, batch, tc, dev)
        del params
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        gen = torch.Generator(device=dev).manual_seed(6)
        q, k, v = (torch.randn((1, 1536, n, d), generator=gen, device=dev)
                   .requires_grad_() for n in (h, kv, kv))
        ct = torch.randn((1, 1536, h, d), generator=gen, device=dev)
        res = []
        for attn in (B.chunked_causal_attention, B.full_causal_attention):
            o = attn(q, B._gqa_expand(k, h), B._gqa_expand(v, h))
            res.append({"o": o.detach(), **dict(zip("qkv", torch.autograd.grad(
                o, (q, k, v), ct)))})
        err = _worst(*res)
        log(f"  {arch} heads {h}:{kv} of {d}, S = 1536: chunked against full "
            f"attention, output and grads worst {err:.2e} of the max (gate "
            "1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{arch}: chunked and full attention differ")
        del q, k, v, ct, res
        gc.collect()
        torch.cuda.empty_cache()


def run_train(card, counters, dev) -> dict:
    """olmo-1b at full width and depth: fp32 params, bf16 compute, remat
    "full", AdamW (lr 1e-3, warmup 2), 4x2048 tokens a step from the
    synthetic pipeline (data vocabulary 64). Six steps, the first a warm-up,
    then one step with 2 microbatches, with the launch counters zeroed
    before and read after: no kernel may launch (flash and decode attention
    have no backward). Gates: every loss finite; the first within 0.5 of a
    random model's, ln V plus half the logits' variance (V = 50304, and the
    tied head's logits have variance d * 0.02² = 0.82 under the
    non-parametric final norm); the last below the first. Then one profiled
    step, broken down by the ops that launched its kernels: ``aten::mm``
    (the weight matmuls and the head), ``aten::bmm`` (the attention
    einsums) and the rest (elementwise work, reductions, copies), and one
    AdamW update profiled alone."""
    import math

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)

    cfg = get_arch("olmo-1b")
    b, s, steps = TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params = M.init_params(cfg, 0, device=dev)
    opt = T.make_opt_state(params, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=s, global_batch=b,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(steps + 2)]
    n_params = sum(p.numel() for p in leaves(params))
    flops = train_flops(cfg, params, b, s)
    log(f"train: {cfg.name} {cfg.n_layers} layers, {n_params} params, "
        f"{b}x{s} tokens a step, bf16 compute, remat full [{card}]")

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = T.make_train_step(cfg, tc, oc, device=dev)
    step_mb2 = T.make_train_step(cfg, dataclasses.replace(tc, microbatches=2),
                                 oc, device=dev)
    losses, secs = [], []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        params, opt, metrics = (step_mb2 if i == steps else step)(
            params, opt, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        log(f"  step {i}{' (2 microbatches)' if i == steps else ''}: loss "
            f"{losses[-1]:.4f}, grad_norm {float(metrics['grad_norm']):.4f}, "
            f"{1e3 * secs[-1]:.1f} ms")
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    first_want = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not abs(losses[0] - first_want) <= 0.5:
        raise AssertionError(f"first loss {losses[0]:.4f} is not within 0.5 "
                             f"of a random model's {first_want:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the train path launched kernels: {launches}")

    step_s = sorted(secs[1:steps])[(steps - 1) // 2]
    numbers = {
        "arch": cfg.name, "card": card, "params": n_params,
        "tokens_per_step": b * s, "remat": "full", "compute": "bfloat16",
        "losses": losses, "first_loss_want": first_want,
        "ms_per_step": 1e3 * step_s, "ms_per_step_all": [1e3 * x for x in secs],
        "tokens_per_s": b * s / step_s, "peak_gb": peak / 1e9,
        "model_flops": flops, "bound_ms": 1e3 * flops / PEAK_FLOPS["bfloat16"],
        "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
        "launches": launches,
    }
    numbers["profile"] = profile_train_step(
        lambda: step(params, opt, batches[steps + 1]), step_s)
    # the AdamW update's share of "other": one update alone, profiled
    grads = T.make_grad_fn(cfg, tc, device=dev)(params, {
        k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()})[2]
    numbers["profile"]["adamw_ms"] = profile_train_step(
        lambda: adamw_update(oc, params, grads, opt), step_s)["device_ms"]
    return numbers


def check_remat(cfg, params, batch, tc, dev) -> None:
    """remat none, full and dots on one batch: gradients within 1e-6 of
    each leaf's largest entry."""
    from repro_torch.train import train_step as T

    want = None
    for remat in ("none", "full", "dots"):
        grads = T.make_grad_fn(cfg, dataclasses.replace(tc, remat=remat),
                               device=dev)(params, batch)[2]
        if want is None:
            want = grads
            continue
        err = _worst(grads, want)
        log(f"  {cfg.name}, {cfg.n_layers} layers, 1x1536: remat {remat} "
            f"against none, grads worst {err:.2e} of the leaf max (gate 1e-6)")
        if not err <= 1e-6:
            raise AssertionError(f"{cfg.name}: remat {remat} changes grads")


def check_family_train_parity(card, dev, families=None) -> None:
    """The other families' train paths at full width and reduced depth,
    fp32 (TF32 off), the zero-init leaves seeded (_enliven): rwkv6-7b with
    1 layer, zamba2-7b with 7 (one period of 5 Mamba-2 layers and the
    shared attention block, then one trailing layer) and olmoe-1b-7b with
    1 (its aux loss in the loss). One train step (its gradients, then the
    AdamW update) on the card against the same step on the CPU, at 2x200
    (the scans: three chunks of 64 and a ragged tail of 8) or 2x256
    (olmoe: capacity 80 against a mean load of 64 choices an expert, so
    choices drop and the gate holds the routing too; _moe_drops counts
    them on the CPU, and none fails the phase). Gates: loss within 1e-4 relative; every gradient leaf within
    TRAIN_FAMILIES' gate of its largest entry: 1e-4 for zamba2-7b and
    olmoe-1b-7b, as olmo-1b; 2e-4 for
    rwkv6-7b, as tests/test_torch_train_recurrent.py holds it, since its
    per-head group norm divides by small standard deviations and so
    enlarges the fp32 rounding of the scan (on the CPU at reduced width two
    correct fp32 scans give gradients 4.4e-5 of the leaf max apart);
    params within 2 lr.
    Then, on the card alone at 1x1536, remat none, full and dots give
    gradients within 1e-6 of each leaf's largest entry. ``families``
    (TRAIN_FAMILIES by default) maps each arch to its entries as
    TRAIN_FAMILIES does (chip_smoke_media.py passes the VLM and audio
    families: the VLM's batch carries vision states)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             leaves)


    tc = T.TrainConfig(remat="full", compute_dtype="float32")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    cpu = torch.device("cpu")
    for arch, (_, layers, seq, gate, _) in (families
                                            or TRAIN_FAMILIES).items():
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        # drawn on the card, then copied to the host
        init = M.init_params(cfg, 0, device=dev)
        _enliven(cfg, init, torch.Generator(device=dev).manual_seed(1))
        init = _to(init, cpu)
        batch = TokenPipeline(DataConfig(vocab_size=64, seq_len=seq,
                                         global_batch=2), cfg).batch_at(0)
        log(f"train: {cfg.name} at full width, {layers} layers, fp32: one "
            f"step on the card against the CPU at 2x{seq} [{card}]")
        out = []
        for where in (cpu, dev):
            params = _to(init, where)
            t0 = time.perf_counter()
            loss, _, grads = T.make_grad_fn(cfg, tc, device=where)(
                params, {k: torch.as_tensor(v, device=where)
                         for k, v in batch.items()})
            adamw_update(oc, params, grads, T.make_opt_state(params, tc))
            out.append((float(loss), grads, params,
                        time.perf_counter() - t0))
        if cfg.moe is not None:
            drops = _moe_drops(cfg, init, torch.as_tensor(batch["tokens"]))
            log(f"  choices dropped at capacity in the first layer (CPU): "
                f"{drops} of {2 * seq * cfg.moe.top_k}")
            if not drops:
                raise AssertionError(f"{arch}: no choice dropped, so the "
                                     "gate would not hold the capacity")
        (cl, cg, cp, cs), (gl, gg, gp, _) = out
        loss_err, grad_err = abs(gl - cl) / abs(cl), _worst(gg, cg)
        param_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(leaves(gp), leaves(cp)) if b.numel())
        log(f"  loss {gl:.6f} (CPU {cl:.6f}, rel err {loss_err:.2e}, gate "
            f"1e-4), grads worst {grad_err:.2e} of the leaf max (gate "
            f"{gate:g}), params max_abs_err {param_err:.2e} (gate "
            f"{2 * oc.lr:g}); CPU {cs:.1f} s")
        if not (loss_err <= 1e-4 and grad_err <= gate
                and param_err <= 2 * oc.lr):
            raise AssertionError(f"{arch} train step: card and CPU disagree")
        del out, gg, cg, gp, cp, init

        params = M.init_params(cfg, 0, device=dev)
        _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
        rng = np.random.default_rng(5)
        batch = {k: v.to(dev) for k, v in model_batch(cfg, rng, 1,
                                                      1536).items()}
        batch["labels"] = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, batch["tokens"].shape), device=dev)
        check_remat(cfg, params, batch, tc, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def train_flops(cfg, params, b: int, s: int) -> int:
    """Model FLOPs of one train step (forward and backward, remat's
    recompute not counted): 6 per weight that multiplies a token (the
    input embedding is a lookup, and is left out unless tied to the head;
    the hybrid's shared block counts once per site; of an MoE layer's
    routed experts only the top k of E count, as ``n_active_params``
    counts them, and the capacity's empty slots are not model FLOPs),
    plus, per layer, the
    sequential recurrence's 4 K V (WKV6) or 4 N P (SSD) per token and head,
    causal attention's 2 S D per query and head (half the pairs, QK^T
    and PV) and the VLM's cross-attention's 4 Nv D (every query sees all
    Nv vision states), each three times (forward, and backward at twice
    the forward). The VLM's wk and wv multiply the B Nv vision states, and
    musicgen's head has K V outputs, as its weights count them.
    """
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import leaves
    weights = sum(p.numel() for p in leaves(params))
    if not cfg.tie_embeddings:
        weights -= params["embed"].numel()
    lay, t = T.build_layout(cfg), b * s
    hd = cfg.resolved_head_dim
    if lay["kind"] == "periodic" and lay["single_block"] == "cross_attn":
        # the VLM: the cross-attention layers' wk and wv multiply the B Nv
        # vision states, not the tokens; the placeholder trailing layer
        # (trailing 0) never runs; each query attends to all Nv vision
        # states, 4 Nv D per query and head (QK^T and PV, no mask)
        attn, nv = params["layers"]["single"]["attn"], cfg.n_vision_tokens
        src = attn["wk"].numel() + attn["wv"].numel()
        if not lay["trailing"]:
            weights -= sum(p.numel()
                           for p in leaves(params["layers"]["trailing"]))
        dense = lay["periods"] * lay["inner_n"] + lay["trailing"]
        return (6 * (weights - src) * t + 6 * src * b * nv
                + 6 * dense * t * cfg.n_heads * s * hd
                + 12 * lay["periods"] * t * cfg.n_heads * nv * hd)
    if lay["kind"] == "uniform" and lay["block"] == "moe":
        m, moe = cfg.moe, params["layers"]["moe"]
        weights -= sum(moe[k].numel() for k in ("w_gate", "w_up", "w_down")
                       ) * (m.n_experts - m.top_k) // m.n_experts
    if lay["kind"] == "uniform" and lay["block"] in ("dense", "moe"):
        return 6 * weights * t + 6 * lay["n"] * t * cfg.n_heads * s * \
            cfg.resolved_head_dim
    if lay["kind"] == "uniform":
        k = cfg.rwkv.head_dim
        return 6 * weights * t + 12 * lay["n"] * t * cfg.d_model * k
    mc, sites = cfg.mamba, lay["periods"]
    shared = sum(p.numel() for p in leaves(params["shared_block"]))
    mamba_layers = sites * lay["inner_n"] + lay["trailing"]
    return (6 * (weights + (sites - 1) * shared) * t
            + 12 * mamba_layers * t * mc.n_heads(cfg.d_model) * mc.d_state
            * mc.head_dim
            + 6 * sites * t * cfg.n_heads * s * cfg.resolved_head_dim)


def run_train_family(card, counters, dev, arch, families=None) -> dict:
    """rwkv6-7b, zamba2-7b or olmoe-1b-7b (or another arch of ``families``,
    TRAIN_FAMILIES by default) at full width and its depth there: fp32 params (the zero-init leaves seeded), bf16 compute, remat
    "full", AdamW (lr 1e-3, warmup 2), 4x2048 tokens a step from the
    synthetic pipeline (data vocabulary 64). Six steps, the first a
    warm-up, then one profiled step, with the launch counters zeroed before
    and read after: no kernel may launch (the scans and the MoE run in
    plain torch). Gates: every loss finite; the last below the first; the
    steps' peak device memory at most TRAIN_PEAK_BYTES. The profiled step
    is split by the op that launched each kernel: the scan (``wkv6_chunked``
    or ``ssd_chunked``: the ops under its record_function and the backward
    nodes of those ops; none for olmoe), ``aten::mm`` (the weight matmuls,
    the MoE router and the head), ``aten::bmm`` (the expert products and
    the attention einsums) and the rest."""
    import math

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import OptimizerConfig, leaves

    layers, _, _, _, scan = (families or TRAIN_FAMILIES)[arch]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    b, s, steps = TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params = M.init_params(cfg, 0, device=dev)
    _enliven(cfg, params, torch.Generator(device=dev).manual_seed(1))
    opt = T.make_opt_state(params, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=s, global_batch=b,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(steps + 1)]
    n_params = sum(p.numel() for p in leaves(params))
    flops = train_flops(cfg, params, b, s)
    log(f"train: {cfg.name} {layers} of {full.n_layers} layers, {n_params} "
        f"params, {b}x{s} tokens a step, bf16 compute, remat full [{card}]")

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = T.make_train_step(cfg, tc, oc, device=dev)
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        log(f"  step {i}: loss {losses[-1]:.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.4f}, {1e3 * secs[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(secs[1:])[(steps - 1) // 2]
    profile = profile_train_step(
        lambda: step(params, opt, batches[steps]), step_s, scan=scan)
    launches = {k: c.launches for k, c in counters.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{arch}: the train path launched kernels: "
                             f"{launches}")
    if not peak <= TRAIN_PEAK_BYTES:
        raise AssertionError(f"{arch}: peak {peak / 1e9:.1f} GB passes "
                             f"{TRAIN_PEAK_BYTES / 1e9:g} GB; cut its depth")
    return {
        "arch": cfg.name, "card": card, "layers": layers,
        "layers_of": full.n_layers, "params": n_params,
        "tokens_per_step": b * s, "remat": "full", "compute": "bfloat16",
        "losses": losses, "ms_per_step": 1e3 * step_s,
        "ms_per_step_all": [1e3 * x for x in secs],
        "tokens_per_s": b * s / step_s, "peak_gb": peak / 1e9,
        "model_flops": flops, "bound_ms": 1e3 * flops / PEAK_FLOPS["bfloat16"],
        "train_mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
        "launches": launches, "profile": profile,
    }


def run_checkpoints(card, counters, dev) -> dict:
    """olmo-1b at full width and CKPT_LAYERS layers, otherwise as in
    run_train (fp32 params, bf16 compute, remat "full", AdamW lr 1e-3 with
    warmup 2, 4x2048 tokens of the synthetic pipeline) under
    ``TrainSupervisor``: CKPT_STEPS steps, a
    checkpoint every CKPT_SAVE_EVERY, a non-external ``JobPreempted`` once
    at step CKPT_FAIL_AT, in a temporary ``AcaiProject`` under build/ that
    is deleted at the end. Gates and numbers: see the module docstring."""
    import math
    import resource
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.convert import flatten
    from repro_torch.core.acai import AcaiProject
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as T
    from repro_torch.train.checkpoints import CheckpointManager
    from repro_torch.train.fault import JobPreempted, TrainSupervisor
    from repro_torch.train.optimizer import OptimizerConfig, leaves, tree_map

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=CKPT_LAYERS)
    tc = T.TrainConfig(remat="full")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step = T.make_train_step(cfg, tc, oc, device=dev)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=TRAIN_LEN,
                                    global_batch=TRAIN_BATCH,
                                    markov_temp=2.5), cfg)
    times = {"save_ms": [], "restore_ms": []}

    class TimedCheckpoints(CheckpointManager):
        def save(self, *args, **kw):
            t0 = time.perf_counter()
            ref = super().save(*args, **kw)
            times["save_ms"].append(1e3 * (time.perf_counter() - t0))
            log(f"  save {ref}: {times['save_ms'][-1]:.1f} ms")
            return ref

        def restore(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().restore(*args, **kw)
            torch.cuda.synchronize()
            times["restore_ms"].append(1e3 * (time.perf_counter() - t0))
            log(f"  restore of step {out[1]}: "
                f"{times['restore_ms'][-1]:.1f} ms")
            return out

    losses, stamps, current = [], [], {}

    def batch_fn(i):
        current["step"] = i
        return pipe.batch_at(i)

    def step_fn(params, opt, batch):
        params, opt, metrics = step(params, opt, batch)
        losses.append((current["step"], float(metrics["loss"])))
        log(f"  step {current['step']}: loss {losses[-1][1]:.6f}")
        return params, opt, metrics

    def clock():
        stamps.append(time.perf_counter())
        return stamps[-1]

    pending = {CKPT_FAIL_AT}

    def failure_hook(i):
        if i in pending:
            pending.discard(i)
            log(f"  injected failure at step {i}")
            raise JobPreempted(f"injected failure at step {i}")

    rss = RssSampler()
    params = M.init_params(cfg, 0, device=dev)
    # a one-item list, popped into the run: nothing here keeps the state,
    # so the restore frees the state it replaces
    start = [{"params": params, "opt": T.make_opt_state(params, tc),
              "step": 0}]
    n_params = sum(p.numel() for p in leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(start[0]["opt"]) + leaves(params))
    del params
    workdir = Path(tempfile.mkdtemp(prefix="acai-ckpt-", dir=ROOT / "build"))
    rss.start()
    try:
        disk_free = shutil.disk_usage(workdir).free
        log(f"checkpoints: {cfg.name}, {n_params} params, {state_bytes} "
            f"bytes of state; {disk_free / 1e9:.2f} GB free under "
            f"{workdir}, {2 * state_bytes / 1e9:.2f} GB planned (2 saves) "
            f"[{card}]")
        if disk_free < CKPT_MIN_FREE:
            raise AssertionError(f"{disk_free / 1e9:.2f} GB free under "
                                 f"{workdir}; the phase needs "
                                 f"{CKPT_MIN_FREE / 1e9:.0f} GB")
        project = AcaiProject("smoke", workdir)
        data_ref = pipe.register(project, "olmo-1b-data", creator="trainer")
        ckpt = TimedCheckpoints(project, "olmo-1b-run")
        sup = TrainSupervisor(ckpt, save_every=CKPT_SAVE_EVERY)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, report = sup.run(step_fn, start.pop(), CKPT_STEPS,
                                batch_fn, failure_hook=failure_hook,
                                time_fn=clock)
        launches = {k: c.launches for k, c in counters.items()}
        want = {"restarts": 1, "checkpoints": 2, "steps_run": 5,
                "final_step": CKPT_STEPS}
        got = {k: getattr(report, k) for k in want}
        if got != want:
            raise AssertionError(f"supervisor report {got}, wanted {want}")
        if ckpt.latest_step() != CKPT_STEPS:
            raise AssertionError(f"latest step {ckpt.latest_step()}")
        metas = [project.metadata.get(a) for a in project.metadata.find(
            kind="checkpoint", run="olmo-1b-run")]
        if sorted(m["step"] for m in metas) != [2, 4] or not all(
                math.isfinite(m["loss"]) for m in metas):
            raise AssertionError(f"checkpoint metadata {metas}")

        live = {"params": state["params"], "opt": state["opt"]}
        restored, at = ckpt.restore(tree_map(torch.empty_like, live))
        live_flat = flatten(live)
        mismatched = [key for key, leaf in flatten(restored).items()
                      if not _bits_equal(leaf, live_flat[key])]
        if at != CKPT_STEPS or mismatched:
            raise AssertionError(f"restored step {at}; leaves that differ "
                                 f"from the live state: {mismatched}")
        del restored
        before, after = [loss for i, loss in losses if i == CKPT_FAIL_AT - 1]
        log(f"  step {CKPT_FAIL_AT - 1}'s loss {before!r} before the restore, "
            f"{after!r} after: bit-equal {before == after}")
        if not abs(after - before) <= 1e-6 * abs(before):
            raise AssertionError(f"step {CKPT_FAIL_AT - 1}'s loss {after} "
                                 f"after the restore, {before} before")
        if any(launches.values()):
            raise AssertionError(f"the checkpoint phase launched kernels: "
                                 f"{launches}")
        npz = project.storage.resolve("/olmo-1b-run-ckpt/state.npz").size
        step_ms = [1e3 * (b - a) for a, b in zip(stamps[::2], stamps[1::2])]
        peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        # the host's hash rates, which bound a save and a restore: SHA-256
        # names the blob, CRC-32 guards each zip entry (written and read)
        sample = live["params"]["embed"].cpu().numpy()
        t0 = time.perf_counter()
        hashlib.sha256(sample).digest()
        t1 = time.perf_counter()
        zlib.crc32(sample)
        t2 = time.perf_counter()
        sample_bytes = sample.nbytes
        del sample
        return {
            "arch": cfg.name, "card": card, "layers": cfg.n_layers,
            "params": n_params,
            "tokens_per_step": TRAIN_BATCH * TRAIN_LEN, "data": data_ref,
            "report": dataclasses.asdict(report), "losses": losses,
            "step2_loss_before": before, "step2_loss_after": after,
            "step2_bit_equal": before == after,
            "restored_bit_equal": True, "launches": launches,
            "state_bytes": state_bytes, "npz_bytes": npz,
            "disk_free_gb": disk_free / 1e9,
            "save_ms": times["save_ms"], "restore_ms": times["restore_ms"],
            "save_gb_per_s": [npz / ms / 1e6 for ms in times["save_ms"]],
            "restore_gb_per_s": [npz / ms / 1e6
                                 for ms in times["restore_ms"]],
            "ms_per_step": step_ms, "straggler_steps": report.straggler_steps,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_host_rss_gb": peak_host / 1e9,
            "phase_host_rss_gb": {"start": rss.first / 1e9,
                                  "peak": rss.peak / 1e9},
            "host_sha256_gb_per_s": sample_bytes / (t1 - t0) / 1e9,
            "host_crc32_gb_per_s": sample_bytes / (t2 - t1) / 1e9,
        }
    finally:
        rss.stop.set()
        rss.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)


def run_platform(card, counters, dev) -> dict:
    """The paper's workflow as jobs through the port's ``AcaiPlatform``
    (``runner="thread"``, one worker, so the two full-width training jobs
    run one at a time and do not time each other), in a lake under build/
    that is deleted at the end: a pipeline of a data job, which uploads
    the data description and makes fileset ``TrainData``, two olmo-1b
    training jobs after it at full
    width and depth (lr 3e-3 and 1e-4, PLATFORM_STEPS steps of 4x2048
    tokens, bf16 compute, remat "full", warmup 2), each saving its params
    with its job's provenance and printing ``[[acai:final_loss=...]]``;
    then an eval job after both that restores the run ``find_min`` names,
    casts it to bf16, prefills each request's prompt (flash attention) and
    serves phase 5's olmo-1b workload (decode attention), printing its
    tokens/s. Gates and numbers: see the module docstring."""
    import hashlib
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.convert import flatten
    from repro_torch.core.acai import AcaiPlatform
    from repro_torch.core.engine.events import (TOPIC_CONTAINER_STATUS,
                                                TOPIC_JOB_PROGRESS)
    from repro_torch.core.engine.lifecycle import TERMINAL_STATUS_VALUES
    from repro_torch.core.engine.registry import JobSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.train import train_step as T
    from repro_torch.train.checkpoints import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_arch("olmo-1b")
    tc = T.TrainConfig(remat="full")
    slots, buf, requests, max_new, prompt_lens = SLICES["olmo-1b"]
    per_call, per_tick = launches_per_call(cfg)
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=TRAIN_LEN,
                                    global_batch=TRAIN_BATCH,
                                    markov_temp=2.5), cfg)
    batches = [pipe.batch_at(i) for i in range(PLATFORM_STEPS)]

    def digest(params) -> str:
        """SHA-256 over every leaf's key, dtype, shape and bytes, in key
        order."""
        h = hashlib.sha256()
        for key, leaf in sorted(flatten(params).items()):
            h.update(f"{key} {leaf.dtype} {tuple(leaf.shape)}".encode())
            if leaf.numel():
                h.update(leaf.detach().contiguous().cpu().reshape(-1)
                         .view(torch.uint8).numpy())
        return h.hexdigest()

    def launched():
        return {k: c.launches for k, c in counters.items()}

    # the engine's own events, stamped with the host clock and the card's
    # memory: a job starts at its "running" progress event and ends at
    # its terminal status, which its worker publishes after the runner's
    # wait for the card and the commit of its outputs
    marks = {}

    def memory():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def on_progress(msg):
        if msg.get("stage") == "running":
            before = memory()
            torch.cuda.reset_peak_memory_stats()
            marks[msg["job_id"]] = {"start": time.perf_counter(),
                                    "before": before,
                                    "launches_before": launched()}

    def on_status(msg):
        mark = marks.get(msg["job_id"])
        if msg.get("status") in TERMINAL_STATUS_VALUES and mark is not None:
            mark.update(end=time.perf_counter(), after=memory(),
                        peak=torch.cuda.max_memory_allocated(),
                        launches={k: n - mark["launches_before"][k]
                                  for k, n in launched().items()})

    workdir = Path(tempfile.mkdtemp(prefix="acai-platform-",
                                    dir=ROOT / "build"))
    eng = None
    try:
        disk_free = shutil.disk_usage(workdir).free
        log(f"platform: {cfg.name} through AcaiPlatform(runner='thread', "
            f"max_workers=1), lake under {workdir} with "
            f"{disk_free / 1e9:.2f} GB free [{card}]")
        if disk_free < PLATFORM_MIN_FREE:
            raise AssertionError(f"{disk_free / 1e9:.2f} GB free under "
                                 f"{workdir}; the phase needs "
                                 f"{PLATFORM_MIN_FREE / 1e9:.0f} GB")
        plat = AcaiPlatform(workdir, runner="thread", max_workers=1)
        admin = plat.create_project(plat.admin_token, "smoke")
        proj = plat.project(admin)
        eng = plat.engine(admin)
        eng.bus.subscribe(TOPIC_JOB_PROGRESS, on_progress)
        eng.bus.subscribe(TOPIC_CONTAINER_STATUS, on_status)

        def data_job(workdir, job):
            print(proj.upload(
                "/data/dataset.json",
                json.dumps(dataclasses.asdict(pipe.cfg)).encode(),
                creator=job.spec.user))
            print(proj.create_file_set("TrainData", ["/data/dataset.json"],
                                       creator=job.spec.user))

        def train_job(workdir, job):
            lr = job.spec.args["lr"]
            step = T.make_train_step(cfg, tc, OptimizerConfig(
                lr=lr, warmup_steps=2, total_steps=100), device=dev)
            params = M.init_params(cfg, 0, device=dev)
            opt = T.make_opt_state(params, tc)
            losses, step_s = [], []
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
                print(f"  step {i}: loss {losses[-1]:.4f}, "
                      f"{1e3 * step_s[-1]:.1f} ms")
            del opt
            t0 = time.perf_counter()
            ref = CheckpointManager(proj, f"run-lr{lr}").save(
                PLATFORM_STEPS, params, extra={"final_loss": losses[-1]},
                job_id=job.job_id, input_fileset="TrainData")
            save_s = time.perf_counter() - t0
            print(f"[[acai:final_loss={losses[-1]}]]")
            return {"losses": losses, "step_s": step_s, "save_s": save_s,
                    "checkpoint": ref, "params_sha256": digest(params)}

        def eval_job(workdir, job):
            best = proj.metadata.find_min("final_loss", kind="job")
            trained = eng.registry.get(best)
            run = f"run-lr{trained.spec.args['lr']}"
            t0 = time.perf_counter()
            state, at = CheckpointManager(proj, run).restore(
                {"params": M.init_params(cfg, 0, device=dev)})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            bit_equal = digest(state["params"]) == \
                trained.outputs["params_sha256"]
            params = M.cast_params(state["params"], torch.bfloat16)
            del state
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab_size, rng.integers(
                prompt_lens[0], prompt_lens[1] + 1)).tolist()
                for _ in range(requests)]
            before = launched()
            prefill = D.make_prefill_step(cfg, device=dev)
            pre = [prefill(params, {"tokens": torch.tensor([p])})[0]
                   .float().cpu() for p in prompts]
            res = L.serve(cfg, params, prompts, slots=slots, buf=buf,
                          max_new=max_new, device=dev)
            launches = {k: n - before[k] for k, n in launched().items()}
            tokens_per_s = requests * max_new / res.seconds
            ok = all(bool(torch.isfinite(t).all())
                     for t in pre + res.first_logits) and all(
                len(o) == max_new and 0 <= min(o) and
                max(o) < cfg.vocab_size for o in res.outputs)
            print(f"[[acai:tokens_per_s={tokens_per_s},ticks={res.ticks}]]")
            return {"best": best, "run": run, "restored_step": at,
                    "restore_s": restore_s, "bit_equal": bit_equal,
                    "serve_s": res.seconds, "ticks": res.ticks,
                    "tokens_per_s": tokens_per_s, "outputs_ok": ok,
                    "launches": launches, "prefill_calls": len(prompts)}

        sweep = plat.pipeline(admin, "sweep")
        data = sweep.stage(JobSpec(name="data", project="", user="",
                                   fn=data_job))
        runs = [sweep.stage(JobSpec(
            name=f"train-lr{lr}", project="", user="", fn=train_job,
            input_fileset="TrainData", args={"lr": lr},
            resources={"vcpu": 8, "mem_mb": 8192}), after=data)
            for lr in PLATFORM_LRS]
        sweep.stage(JobSpec(name="eval", project="", user="", fn=eval_job,
                            resources={"vcpu": 8, "mem_mb": 8192}),
                    after=runs)
        for c in counters.values():
            c.launches = 0
        handles = sweep.run()
        states = sweep.wait(timeout=1200)
        # the handles resolve at the engine's monitor; this phase's own
        # handlers on the same events have run once the workers are idle
        eng.scheduler.run_to_completion()
        launches = launched()
        # what stays after the jobs: torch keeps a cuBLAS workspace per
        # (handle, stream), and each thread has its own handle
        retained = memory()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        after_clear = memory()
        jobs = [h.job for h in handles]
        for job, state in zip(jobs, states):
            if state.value != "FINISHED":
                raise AssertionError(f"{job.job_id} ({job.spec.name}) ended "
                                     f"{state.value}: {job.error}")
        data_j, *trains, ev = jobs
        out = ev.outputs

        # gates
        spans = sorted((marks[j.job_id]["start"], marks[j.job_id]["end"])
                       for j in jobs)
        one_at_a_time = all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        log(f"  the {len(jobs)} jobs ran one at a time: {one_at_a_time}")
        if not one_at_a_time:
            raise AssertionError(f"jobs overlapped: {spans}")
        losses = {j.job_id: j.outputs["losses"][-1] for j in trains}
        if not all(math.isfinite(x) for j in trains
                   for x in j.outputs["losses"]):
            raise AssertionError(f"non-finite training loss: {losses}")
        if out["best"] != min(losses, key=losses.get):
            raise AssertionError(f"find_min named {out['best']}, final "
                                 f"losses {losses}")
        for j in trains:
            back = proj.provenance.backward(
                f"run-lr{j.spec.args['lr']}-ckpt:1")
            if not any(src == "TrainData:1" for src, _ in back):
                raise AssertionError(f"{j.job_id}'s checkpoint does not "
                                     f"lead back to TrainData:1: {back}")
            # consistency only: the job returns with nothing queued (see
            # the module docstring), so this holds with or without the
            # runner's device wait
            if not j.runtime >= sum(j.outputs["step_s"]):
                raise AssertionError(
                    f"{j.job_id}: engine runtime {j.runtime} s < its "
                    f"synchronized steps' {sum(j.outputs['step_s'])} s")
        for j in (data_j, *trains):
            if any(marks[j.job_id]["launches"].values()):
                raise AssertionError(f"{j.job_id} launched kernels: "
                                     f"{marks[j.job_id]['launches']}")
        if not (out["bit_equal"] and out["restored_step"] == PLATFORM_STEPS):
            raise AssertionError(f"restore of {out['run']}: step "
                                 f"{out['restored_step']}, bit-equal "
                                 f"{out['bit_equal']}")
        if not out["outputs_ok"]:
            raise AssertionError("the eval job's logits or outputs are "
                                 "non-finite or out of range")
        want = {k: out["prefill_calls"] * per_call.get(k, 0)
                + out["ticks"] * per_tick.get(k, 0) for k in counters}
        if out["launches"] != want or launches != want or \
                marks[ev.job_id]["launches"] != want:
            raise AssertionError(f"eval launches {out['launches']} (phase "
                                 f"{launches}), expected {want}")
        for j in jobs:
            m = marks[j.job_id]
            log(f"  {j.job_id} {j.spec.name}: device memory "
                f"{m['before'] / 1e9:.3f} GB before, {m['peak'] / 1e9:.3f} "
                f"GB peak, {m['after'] / 1e9:.3f} GB after")
            if not m["after"] - m["before"] <= MEMORY_RETURN_BYTES:
                raise AssertionError(
                    f"{j.job_id} left {(m['after'] - m['before']) / 1e9:.3f}"
                    f" GB on the card")

        def row(j):
            m = marks[j.job_id]
            own = sum(j.outputs["step_s"]) if "step_s" in j.outputs \
                else j.outputs.get("serve_s")
            return {"name": j.spec.name, "state": j.state.value,
                    "runtime_s": j.runtime, "own_s": own,
                    "save_s": j.outputs.get("save_s"),
                    "restore_s": j.outputs.get("restore_s"),
                    "cpu_pricing_cost": j.cost,
                    "before_gb": m["before"] / 1e9,
                    "peak_gb": m["peak"] / 1e9, "after_gb": m["after"] / 1e9,
                    "launches": m["launches"]}

        numbers = {
            "arch": cfg.name, "card": card, "runner": "thread",
            "max_workers": 1, "one_at_a_time": one_at_a_time,
            "jobs": {j.job_id: row(j) for j in jobs},
            "final_losses": losses, "best": out["best"],
            "best_lr": eng.registry.get(out["best"]).spec.args["lr"],
            "step_ms": {j.job_id: [1e3 * x for x in j.outputs["step_s"]]
                        for j in trains},
            "restored_bit_equal": out["bit_equal"],
            "eval_ticks": out["ticks"], "eval_serve_s": out["serve_s"],
            "eval_tokens_per_s": out["tokens_per_s"],
            "eval_metadata_tokens_per_s":
                proj.metadata.get(ev.job_id)["tokens_per_s"],
            "launches": launches, "retained_gb": retained / 1e9,
            "retained_gb_after_clearing_cublas_workspaces":
                after_clear / 1e9 if clear is not None else None,
        }
        log(f"  best run {out['run']} ({out['best']}); the eval job served "
            f"{requests} requests in {out['ticks']} ticks, "
            f"{out['tokens_per_s']:.2f} tokens/s")
        return numbers
    finally:
        if eng is not None:
            eng.launcher.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)


def slice_prompts(cfg, shape) -> list:
    """Phase 5's requests of ``cfg`` at ``shape`` (run_slice draws them
    from seed 0 after its 4x2048 prefill batch)."""
    import numpy as np
    _, _, requests, _, prompt_lens = shape
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))
    return [rng.integers(0, cfg.vocab_size,
                         rng.integers(prompt_lens[0], prompt_lens[1] + 1)
                         ).tolist() for _ in range(requests)]


def gpu_memory_used() -> int:
    """The card's ``memory.used`` from nvidia-smi, in MiB."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.strip().splitlines()[0])


def _reap(pid: int, timeout: float) -> bool:
    """Wait up to ``timeout`` s for the child ``pid`` to exit (and reap
    it); True once it has."""
    import os
    deadline = time.perf_counter() + timeout
    while True:
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return True
        except ChildProcessError:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True             # not our child, and gone
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.05)


class MemorySampler(threading.Thread):
    """The card's largest ``memory.used`` (nvidia-smi, MiB), read every
    0.25 s while it runs."""

    def __init__(self):
        super().__init__(daemon=True)
        self.stop = threading.Event()
        self.peak = gpu_memory_used()

    def run(self):
        while not self.stop.wait(0.25):
            self.peak = max(self.peak, gpu_memory_used())


def run_durable(card) -> dict:
    """Phase 9 (see the module docstring): the durable control plane and
    the subprocess runner on the card, through
    ``AcaiPlatform(root, runner="subprocess", durable=True)`` under build/:
    overlapping jobs in one worker, the engine's death, the worker's death
    and a shutdown. Its jobs are ``repro_torch/examples/card_jobs.py``'s,
    since a job that crosses the process boundary must be importable."""
    import math
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.configs.base import get_arch
    from repro_torch.core.acai import AcaiPlatform
    from repro_torch.core.engine.handle import JobHandle
    from repro_torch.core.engine.registry import JobSpec
    from repro_torch.examples import card_jobs as CJ

    cfg = get_arch("olmo-1b")
    slots, buf, _, max_new, _ = SLICES["olmo-1b"]
    per_call, per_tick = launches_per_call(cfg)
    prompts = slice_prompts(cfg, SLICES["olmo-1b"])[:DURABLE_REQUESTS]
    workdir = Path(tempfile.mkdtemp(prefix="acai-durable-",
                                    dir=ROOT / "build"))
    train = {"arch": cfg.name, "layers": DURABLE_LAYERS, "batch": TRAIN_BATCH,
             "seq": TRAIN_LEN}
    live = []               # the platforms whose engines still run
    pids = set()
    sampler = None

    def platform():
        plat = AcaiPlatform(workdir, runner="subprocess", durable=True,
                            quota_k=4)
        t0 = time.perf_counter()
        admin = plat.create_project(plat.admin_token, "smoke")
        eng = plat.engine(admin)
        live.append(eng)
        return plat, admin, eng, time.perf_counter() - t0

    def spec(name, fn, **args):
        return JobSpec(name=name, project="", user="", fn=fn, args=args,
                       resources={"vcpu": 8, "mem_mb": 8192})

    def finished(h, timeout=300):
        state = h.wait(timeout=timeout)
        if state.value != "FINISHED":
            raise AssertionError(f"{h.job_id} ({h.job.spec.name}) ended "
                                 f"{state.value}: {h.job.error}")
        return h.job

    def die(eng):
        """The engine's process dies: its store closes and its socket
        drops, and nothing is shut down."""
        eng.store.close()
        eng.launcher._disconnect()
        live.remove(eng)

    def after_step(path, step, timeout=180):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if path.exists() and len(path.read_text().splitlines()) > step:
                return
            time.sleep(0.05)
        raise AssertionError(f"{path} never reached step {step}")

    def own_lines(job):
        lines = job.outputs["log"].splitlines()
        tagged = [ln for ln in lines if ln.startswith("job-")]
        return tagged, all(ln.startswith(f"{job.job_id} ") for ln in tagged)

    # nvidia-smi's per-process list (--query-compute-apps) did not name the
    # worker's pid on the card's machine (it listed one process, pid 1), so
    # the worker's memory is read off the card's memory.used, beside which
    # this process holds still through the phase
    mem_before = gpu_memory_used()

    def worker_mib():
        return gpu_memory_used() - mem_before

    numbers = {"card": card, "arch": cfg.name, "train_layers": DURABLE_LAYERS,
               "requests": len(prompts), "memory_used_before_mib": mem_before}
    try:
        # -- 1. overlapping jobs in one worker ---------------------------
        t0 = time.perf_counter()
        plat, admin, eng, _ = platform()
        proj = plat.project(admin)
        probe = plat.submit_job(admin, spec("probe", CJ.probe_job))
        up_s = time.perf_counter() - t0         # the launch waited for it
        probe = finished(probe, timeout=120)
        ready_s = time.perf_counter() - t0
        pid = probe.outputs["pid"]
        pids.add(pid)
        log(f"durable: worker {pid} up in {up_s:.2f} s, CUDA and the kernel "
            f"libraries ready in {ready_s:.2f} s ({probe.outputs['device']})")
        ready_mib = worker_mib()
        if not ready_mib >= 256:
            raise AssertionError(f"the card's memory.used moved {ready_mib} "
                                 f"MiB with the worker's CUDA context")
        sampler = MemorySampler()
        sampler.start()
        handles = [plat.submit_job(admin, spec(
            f"train-lr{lr}", CJ.train_job, lr=lr, steps=DURABLE_STEPS,
            **train)) for lr in PLATFORM_LRS]
        handles.append(plat.submit_job(admin, spec(
            "serve", CJ.serve_job, arch=cfg.name, prompts=prompts,
            slots=slots, buf=buf, max_new=max_new)))
        jobs = [finished(h) for h in handles]
        *trains, serve = jobs
        between = worker_mib()
        outs = [j.outputs for j in jobs]
        if not max(o["started"] for o in outs) < \
                min(o["ended"] for o in outs):
            raise AssertionError("the three jobs did not overlap: " + str(
                [(o["started"], o["ended"]) for o in outs]))
        streams = [o["stream"] for o in outs]
        if len(set(streams)) != 3 or outs[0]["default_stream"] in streams:
            raise AssertionError(f"the jobs' streams {streams} are not three "
                                 f"of their own")
        for j in jobs:
            tagged, own = own_lines(j)
            want = DURABLE_STEPS if j in trains else 1
            if not own or len(tagged) != want:
                raise AssertionError(f"{j.job_id}'s log holds other lines: "
                                     f"{tagged}")
        losses = {j.job_id: j.outputs["losses"][-1] for j in trains}
        if not all(math.isfinite(x) for j in trains
                   for x in j.outputs["losses"]):
            raise AssertionError(f"non-finite training loss: {losses}")
        best = proj.metadata.find_min("final_loss", kind="job")
        if best != min(losses, key=losses.get):
            raise AssertionError(f"find_min named {best}, final losses "
                                 f"{losses}")
        for j in trains:
            if not j.runtime >= sum(j.outputs["step_s"]):
                raise AssertionError(
                    f"{j.job_id}: engine runtime {j.runtime} s < its "
                    f"synchronized steps' {sum(j.outputs['step_s'])} s")
        out = serve.outputs
        want = {k: out["prefill_calls"] * per_call.get(k, 0)
                + out["ticks"] * per_tick.get(k, 0) for k in launch_counters()}
        if out["launches"] != want or not out["outputs_ok"]:
            raise AssertionError(f"serve job: launches {out['launches']}, "
                                 f"expected {want}; outputs ok "
                                 f"{out['outputs_ok']}")
        numbers.update({
            "worker_up_s": up_s, "spawn_to_ready_s": ready_s,
            "jobs": {j.job_id: {
                "name": j.spec.name, "runtime_s": j.runtime,
                "own_s": sum(j.outputs["step_s"]) if j in trains
                else j.outputs["serve_s"], "cpu_pricing_cost": j.cost}
                for j in jobs},
            "step_ms": {j.job_id: [1e3 * s for s in j.outputs["step_s"]]
                        for j in trains},
            "final_losses": losses, "best": best,
            "serve_ticks": out["ticks"], "serve_tokens_per_s":
                out["tokens_per_s"], "launches": out["launches"]})

        # -- 2. the engine dies, the worker runs on ----------------------
        marker = workdir / "marker-engine.txt"
        progress = workdir / "progress-engine.txt"
        h = plat.submit_job(admin, spec(
            "train-engine-death", CJ.train_job, lr=PLATFORM_LRS[0],
            steps=DURABLE_RECOVER_STEPS, progress=str(progress),
            marker=str(marker), **train))
        jid = h.job_id
        after_step(progress, 2)
        die(eng)
        del plat, eng
        plat2, admin2, eng2, recover_s = platform()
        rep2 = eng2.recovery
        if (rep2.adopted, rep2.requeued) != (1, 0):
            raise AssertionError(f"after the engine's death: {rep2}")
        job = finished(JobHandle(eng2.registry.get(jid), eng2))
        if job.epoch != 0 or marker.read_text().splitlines() != \
                [f"{jid} 0"]:
            raise AssertionError(f"{jid} settled at epoch {job.epoch}, "
                                 f"marker {marker.read_text()!r}")
        first_loss = job.outputs["losses"][0]
        numbers["engine_death"] = {
            "recovery_s": recover_s, "report": dataclasses.asdict(rep2),
            "runtime_s": job.runtime, "own_s": sum(job.outputs["step_s"]),
            "step_ms": [1e3 * s for s in job.outputs["step_s"]]}

        # -- 3. the worker dies too ---------------------------------------
        marker = workdir / "marker-worker.txt"
        progress = workdir / "progress-worker.txt"
        h = plat2.submit_job(admin2, spec(
            "train-worker-death", CJ.train_job, lr=PLATFORM_LRS[0],
            steps=DURABLE_RECOVER_STEPS, progress=str(progress),
            marker=str(marker), **train))
        jid = h.job_id
        after_step(progress, 2)
        victim = json.loads((eng2.launcher.dir / "worker.json")
                            .read_text())["pid"]
        held = worker_mib()
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        die(eng2)
        del plat2, eng2
        while worker_mib() > MEMORY_RETURN_BYTES / 2**20:
            if time.perf_counter() - t_kill > 10:
                raise AssertionError(f"the card still holds {worker_mib()} "
                                     f"MiB of the killed worker {victim} "
                                     f"after 10 s ({held} MiB before)")
            time.sleep(0.1)
        freed_s = time.perf_counter() - t_kill
        _reap(victim, 10)
        plat3, admin3, eng3, recover3_s = platform()
        rep3 = eng3.recovery
        if (rep3.requeued, rep3.adopted) != (1, 0):
            raise AssertionError(f"after the worker's death: {rep3}")
        job = finished(JobHandle(eng3.registry.get(jid), eng3))
        if job.epoch != 1 or marker.read_text().splitlines() != \
                [f"{jid} 1"]:
            raise AssertionError(f"{jid} settled at epoch {job.epoch}, "
                                 f"marker {marker.read_text()!r}")
        rerun_loss = job.outputs["losses"][0]
        if not abs(rerun_loss - first_loss) <= 1e-6 * abs(first_loss):
            raise AssertionError(f"the re-run's first loss {rerun_loss} is "
                                 f"not step 2's {first_loss}")
        pid3 = job.outputs["pid"]
        pids.update((victim, pid3))
        before_shutdown = worker_mib()
        numbers["worker_death"] = {
            "killed_pid": victim, "killed_held_mib": held,
            "kill_to_free_s": freed_s, "recovery_s": recover3_s,
            "report": dataclasses.asdict(rep3), "runtime_s": job.runtime,
            "own_s": sum(job.outputs["step_s"]),
            "step_ms": [1e3 * s for s in job.outputs["step_s"]],
            "first_loss": first_loss, "rerun_first_loss": rerun_loss}

        # -- 4. shutdown --------------------------------------------------
        t0 = time.perf_counter()
        eng3.launcher.shutdown()
        live.remove(eng3)
        gone = {p: _reap(p, 30) for p in pids}
        if not all(gone.values()):
            raise AssertionError(f"workers still alive 30 s after the "
                                 f"shutdown: {gone}")
        shutdown_s = time.perf_counter() - t0
        mem_after = gpu_memory_used()
        if not mem_after - mem_before <= MEMORY_RETURN_BYTES / 2**20:
            raise AssertionError(f"the card's memory.used is {mem_after} MiB "
                                 f"after the phase, {mem_before} MiB before")
        numbers.update({
            "worker_used_mib": {"ready": ready_mib,
                                "peak": sampler.peak - mem_before,
                                "between_jobs": between,
                                "before_shutdown": before_shutdown},
            "shutdown_s": shutdown_s, "memory_used_after_mib": mem_after,
            "worker_pids": sorted(pids)})
        return numbers
    finally:
        if sampler is not None:
            sampler.stop.set()
        for eng in live:
            eng.launcher.shutdown()
        shutil.rmtree(workdir, ignore_errors=True)


class RssSampler(threading.Thread):
    """The process's resident set size (``VmRSS``) every 50 ms while it
    runs: the first reading and the largest."""

    def __init__(self):
        super().__init__(daemon=True)
        self.stop = threading.Event()
        self.first = self.peak = self.read()

    @staticmethod
    def read() -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS line in /proc/self/status")

    def run(self):
        while not self.stop.wait(0.05):
            self.peak = max(self.peak, self.read())


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaN and -0.0 included)."""
    import torch
    if (a.dtype, a.shape) != (b.dtype, b.shape):
        return False
    if not a.numel():
        return True
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def profile_train_step(fn, wall_s, scan=None) -> dict:
    """One call of fn under torch.profiler: device time by the op that
    launched each kernel (``aten::mm``, ``aten::bmm``, the rest), kernels
    per step and the kernels that take the most time. With ``scan``, the
    name of a record_function in the model, the kernels of the ops under it
    (the scan's forward and its remat recompute) and of the backward nodes
    of those ops count as ``scan_ms`` and under no other op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _kernel_rows(prof, 1)
    if not kernels:
        return {"device_ms": "not measured"}
    total = sum(us for us, _, _ in kernels) / 1e3
    split = _device_ms_by_op(prof, scan)
    out = {
        "device_ms": total, "wall_ms_unprofiled": 1e3 * wall_s,
        "device_busy_share": total / (1e3 * wall_s),
        "matmul_ms": split["mm"], "attention_einsum_ms": split["bmm"],
        "other_ms": total - split["mm"] - split["bmm"] - split["scan"],
        "kernels": sum(n for _, n, _ in kernels),
        "top": [{"kernel": k[:60], "ms": us / 1e3, "count": n}
                for us, n, k in kernels[:8]],
    }
    if scan:
        out["scan"], out["scan_ms"] = scan, split["scan"]
    return out


def _device_ms_by_op(prof, scan=None) -> dict:
    """Device ms of a profile's kernels by the CPU op that launched them:
    "scan" (under the record_function ``scan``, or under the backward node
    of an op that ran under it, matched by sequence number and forward
    thread), else "mm" under ``aten::mm``, "bmm" under ``aten::bmm``, and
    "rest"."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    events = prof.events()
    seqs = {(e.sequence_nr, e.thread) for e in events
            if scan and e.sequence_nr >= 0
            and any(a.name == scan for a in chain(e))}
    out = dict.fromkeys(("scan", "mm", "bmm", "rest"), 0.0)
    for e in events:     # an annotation's own "kernel" is its device span
        if e.device_type != DeviceType.CPU or not e.kernels \
                or e.is_user_annotation:
            continue
        names = [a.name for a in chain(e)]
        node = next((a for a in chain(e) if a.scope == 1), None)  # backward
        if scan and (scan in names or node is not None and (
                node.sequence_nr, node.fwd_thread) in seqs):
            key = "scan"
        elif "aten::mm" in names:
            key = "mm"
        elif "aten::bmm" in names:
            key = "bmm"
        else:
            key = "rest"
        out[key] += sum(k.duration for k in e.kernels) / 1e3
    return out


def profile_ticks(cfg, params, card, slots, buf, ticks: int = 20,
                  vision=None) -> dict:
    """Where a decode tick's time goes, at the slice's shape (all slots at
    position buf / 2; the VLM's vision K/V from ``vision``): host wall per
    tick without the profiler, device kernel time per tick and kernels per
    tick under torch.profiler, and the kernels that take the most device
    time; ``profile_s``, the seconds the whole function took. Runs after
    the launch counts are read; it gates nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D

    start = time.perf_counter()
    step = D.make_serve_step(cfg, buf)
    states = T.init_decode_state(cfg, slots, buf,
                                 device=params["embed"].device,
                                 vision=vision, params=params)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    batch = {"tokens": torch.zeros((slots, 1, *books), dtype=torch.long),
             "cache_len": torch.full((slots,), buf // 2, dtype=torch.int32)}

    def run():
        for _ in range(ticks):
            _, _, nxt = step(params, states, batch)
            nxt.cpu()                      # the driver reads every tick

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    # CPU ops are recorded only where _moe_ms reads them: with them a
    # window of 8 ticks took 8-22 s of an H100 host's time
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cfg.moe is not None else [])) as prof:
        run()
    rows = _kernel_rows(prof, ticks)
    device_ms = sum(r[0] for r in rows) / 1e3
    out = {
        "arch": cfg.name, "card": card, "ticks": ticks,
        "wall_ms_per_tick": wall_ms,
        "device_ms_per_tick": device_ms if rows else "not measured",
        "device_busy_share": device_ms / wall_ms if rows else "not measured",
        "kernels_per_tick": sum(r[1] for r in rows),
        "top": [{"kernel": k[:60], "us_per_tick": us, "per_tick": n}
                for us, n, k in rows[:8]],
    }
    if cfg.moe is not None:
        out["moe_block_per_tick"] = _moe_ms(prof, ticks) if rows \
            else "not measured"
    out["profile_s"] = time.perf_counter() - start
    return out


def profile_prefill(cfg, params, card, fn) -> dict:
    """One prefill call of an MoE model under torch.profiler: its device
    ms, kernels, and its MoE blocks' device ms split as _moe_ms does. Runs
    after the launch counts are read; it gates nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, 1)
    if not rows:
        return {"arch": cfg.name, "prefill": "not measured"}
    return {"arch": cfg.name, "card": card,
            "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
            "device_ms_per_prefill": sum(r[0] for r in rows) / 1e3,
            "kernels_per_prefill": sum(r[1] for r in rows),
            "moe_block_per_prefill": _moe_ms(prof, 1),
            "top": [{"kernel": k[:60], "ms": us / 1e3, "count": n}
                    for us, n, k in rows[:8]]}


def _moe_ms(prof, calls: int) -> dict:
    """Device ms per call of the kernels launched under the model's
    ``moe_block`` record_function: the expert products (``aten::bmm``),
    the rest of the block (routing, dispatch, combine, the aux loss, the
    router and shared-expert matmuls), and the block's kernels per call.
    The record_function's own device span is left out."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    out = {"bmm_ms": 0.0, "rest_ms": 0.0, "kernels": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels \
                or e.is_user_annotation:
            continue
        names = [a.name for a in chain(e)]
        if "moe_block" not in names:
            continue
        key = "bmm_ms" if "aten::bmm" in names else "rest_ms"
        out[key] += sum(k.duration for k in e.kernels) / 1e3 / calls
        out["kernels"] += len(e.kernels) / calls
    out["block_ms"] = out["bmm_ms"] + out["rest_ms"]
    return out


def mesh_train_setup(dev):
    """Phase 10's train steps: olmo-1b at full width and
    MESH_TRAIN_LAYERS layers, fp32, remat full, and its seeded batches."""
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    cfg = dataclasses.replace(get_arch("olmo-1b"),
                              n_layers=MESH_TRAIN_LAYERS)
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(MESH_TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1))
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return (cfg, TrainConfig(remat="full", compute_dtype="float32"),
            OptimizerConfig(lr=1e-3, warmup_steps=2), batches)


def _peak_gb(dev) -> float:
    """Peak device memory since the last reset (``reset_peak``); 0 on the
    CPU (a rehearsal)."""
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_steps(step, params, opt, batches, dev) -> dict:
    """Each step's loss, grad norm, ms and the peak since the last reset
    as of its end (``peak_gb`` the last)."""
    losses, norms, ms, peaks = [], [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        peaks.append(_peak_gb(dev))
    return {"losses": losses, "grad_norms": norms, "ms_per_step": ms,
            "peaks_gb": peaks, "peak_gb": peaks[-1]}


def _mesh_one_rank(out, gate, dev) -> None:
    """Phase 10's (1): the one-device train steps, then the same steps on
    a world of one rank on nccl (gloo in a CPU rehearsal) in this
    process."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    cfg, tcfg, ocfg, batches = mesh_train_setup(dev)
    _reset_peak(dev)
    params = M.init_params(cfg, 0, device=dev)
    one = _mesh_steps(TS.make_train_step(cfg, tcfg, ocfg, device=dev),
                      params, TS.make_opt_state(params, tcfg), batches, dev)
    del params
    free()
    # the first batch's step at 2 microbatches, from the same init
    mb2 = dataclasses.replace(tcfg, microbatches=2)
    params = M.init_params(cfg, 0, device=dev)
    one["mb2_loss"] = _mesh_steps(TS.make_train_step(
        cfg, mb2, ocfg, device=dev), params, TS.make_opt_state(params, mb2),
        batches[:1], dev)["losses"][0]
    del params
    free()
    out["one_device"] = one

    # (1) a world of one rank on nccl (gloo in a CPU rehearsal)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    LM.check_backend(backend, dev.type, 1)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{LM.free_port()}", rank=0,
        world_size=1, **({"device_id": torch.device(
            "cuda", torch.cuda.current_device())} if backend == "nccl"
            else {}))
    try:
        mesh = LM.make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        _reset_peak(dev)
        specs = TS.sharded_specs(cfg, mesh)
        params, opt = TS.shard_train_state(M.init_params(cfg, 0, device=dev),
                                           tcfg, *specs[1:], mesh)
        out[backend] = _mesh_steps(TS.make_sharded_train_step(
            cfg, tcfg, ocfg, mesh, device=dev, specs=specs), params, opt,
            batches, dev)
        del params, opt
    finally:
        dist.destroy_process_group()
    free()
    for i, (a, b) in enumerate(zip(out[backend]["losses"], one["losses"])):
        gate(f"{backend} (1, 1) step {i} loss, relative",
             abs(a - b) / abs(b), 1e-4)


def run_mesh(card, dev, kernels_at_rank=None) -> dict:
    """Phase 10 (see the module docstring): the one-device train steps, the
    world of one rank on nccl in this process, then two spawned worlds of
    two gloo ranks on the card, each rank writing its readings to a file
    that this process reads and gates. ``kernels_at_rank``: phase 3's
    ``mesh_kernel_times``, carried into the ``mesh:`` line."""
    import tempfile

    from repro_torch.launch import mesh as LM
    t0 = time.perf_counter()
    out = {"card": card, "gates": {}, "kernels_at_8_heads": kernels_at_rank
           or "not measured"}

    def gate(name, value, limit):
        out["gates"][name] = [value, limit]
        if not value <= limit:
            raise AssertionError(f"mesh: {name} {value:.3e} > {limit:.3e}")

    # the probe's pairs run beside (1) and the one-device steps
    probe = start_gloo_cuda_probe() if dev.type == "cuda" else None
    try:
        _mesh_one_rank(out, gate, dev)
    finally:             # every probe process ends here, by its timeout
        out["gloo_cuda"] = finish_gloo_cuda_probe(probe) if probe \
            else "not measured (no card)"

    # (2) and (3): two gloo ranks sharing the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for part in ("tp", "fsdp"):
            LM.run_ranks(_mesh_rank, 2, (part, tmp, "tcp://localhost:"
                                         f"{LM.free_port()}", dev.type))
        ranks = {part: [json.loads(Path(tmp, f"{part}.{r}.json").read_text())
                        for r in range(2)] for part in ("tp", "fsdp")}
    for r, rank in enumerate(ranks["tp"]):
        for name, (value, limit) in rank["gates"].items():
            gate(f"rank {r} {name}", value, limit)
    # (2)'s train steps: the loss over vocab shards against one device, the
    # first step's grad norm (the head's gradient, which a backward scaled
    # by the model ranks or a wrong one-hot would move) and the second
    # step's loss (after an update from that gradient), and each rank's
    # first-step peak against the dry-run's count of the same cell
    count = ranks["tp"][0]["train"]["count"]
    one = ranks["tp"][0]["train"]["one_device"]
    for r, rank in enumerate(ranks["tp"]):
        got = rank["train"]
        for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
            gate(f"(1, 2) train step {i} rank {r} loss, relative",
                 abs(a - b) / abs(b), 1e-4)
        gate(f"(1, 2) train step 0 rank {r} grad norm, relative",
             abs(got["grad_norms"][0] - one["grad_norms"][0])
             / abs(one["grad_norms"][0]), 1e-4)
        if dev.type == "cuda":
            measured = got["peaks_gb"][0] * 1e9
            gate(f"(1, 2) train step rank {r}: |dry-run peak - measured| / "
                 "measured", abs(count["peak_bytes"] - measured) / measured,
                 DRYRUN_PEAK_TOL)
    out["tp_train"] = {
        "layers": ranks["tp"][0]["train"]["layers"],
        "losses": [rank["train"]["losses"] for rank in ranks["tp"]],
        "one_device_losses": one["losses"],
        "grad_norms": [rank["train"]["grad_norms"] for rank in ranks["tp"]],
        "one_device_grad_norms": one["grad_norms"],
        "ms": [rank["train"]["ms_per_step"] for rank in ranks["tp"]],
        "one_device_ms": one["ms_per_step"],
        "peak_gb": [rank["train"]["peaks_gb"][0] for rank in ranks["tp"]],
        "dryrun_peak_gb": count["peak_bytes"] / 1e9,
        "dryrun_args_gb": count["args_bytes"] / 1e9,
        "dryrun_temp_gb": count["temp_bytes"] / 1e9,
        "dryrun_count_s": count["count_s"],
        "dryrun_collectives": count["collectives"], "card": card}
    for r, rank in enumerate(ranks["fsdp"]):
        for i, (a, b) in enumerate(zip(rank["losses"],
                                       out["one_device"]["losses"])):
            gate(f"fsdp (2, 1) rank {r} step {i} loss, relative",
                 abs(a - b) / abs(b), 1e-4)
        gate(f"fsdp (2, 1) rank {r} microbatches 2 loss, relative",
             abs(rank["mb2"]["losses"][0] - out["one_device"]["mb2_loss"])
             / abs(out["one_device"]["mb2_loss"]), 1e-4)
        gate(f"pod (2, 1, 1) rank {r} step loss, relative",
             abs(rank["pod"]["losses"][0] - out["one_device"]["losses"][0])
             / abs(out["one_device"]["losses"][0]), 1e-4)
        for name, (value, limit) in rank["gates"].items():
            gate(f"pod (2, 1, 1) rank {r} {name}", value, limit)
    out["fsdp_peak_gb"] = {
        "ranks (per-layer gather)": [rank["peak_gb"]
                                     for rank in ranks["fsdp"]],
        "rank gathering whole params and gradients": (
            MESH_FSDP_WHOLE_PEAK_GB),
        "one device": out["one_device"]["peak_gb"]}
    out["ranks"] = ranks["tp"]
    out["fsdp"] = ranks["fsdp"]
    out["backends"] = {"(1, 1) train": "nccl" if dev.type == "cuda"
                       else "gloo", "(1, 2) serve": "gloo",
                       "(2, 1) train": "gloo", "(2, 1, 1) train and serve":
                       "gloo"}
    out["seconds"] = time.perf_counter() - t0
    return out


# one gloo collective on CUDA tensors of three dtypes, between two ranks of
# processes of their own: a collective gloo mishandles can abort its process
GLOO_PROBE = r"""
import json, sys, datetime, torch, torch.distributed as dist
op, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
dev = torch.device("cuda", 0)
out = {}
for dtype in (torch.float32, torch.bfloat16, torch.int8):
    t = torch.full((4,), rank + 1, dtype=dtype, device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(t)
            ok = (t.cpu().float() == 3).all()
        elif op == "all_gather":
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            ok = [p[0].item() for p in parts] == [1, 2]
        elif op == "reduce_scatter":
            o = torch.empty(2, dtype=dtype, device=dev)
            dist.reduce_scatter_tensor(o, t)
            ok = (o.cpu().float() == 3).all()
        elif op == "broadcast":
            dist.broadcast(t, 0)
            ok = (t.cpu().float() == 1).all()
        else:
            b = torch.empty_like(t)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, t, 1 - rank),
                    dist.P2POp(dist.irecv, b, 1 - rank)]):
                w.wait()
            ok = (b.cpu().float() == 2 - rank).all()
        out[str(dtype)] = "ok" if bool(ok) else "wrong values"
    except RuntimeError as e:
        out[str(dtype)] = "refused: " + str(e).splitlines()[0][:120]
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def start_gloo_cuda_probe() -> dict:
    """Which gloo collectives take CUDA tensors on this card's torch: each
    collective between two processes of its own (all five pairs at once),
    on fp32, bf16 and int8 tensors; a pair that aborts or hangs reads as
    such (``finish_gloo_cuda_probe``). The sharded steps stage every gloo
    collective through host memory whatever this finds (spmd.py); it is a
    reading, not a switch."""
    from repro_torch.launch import mesh as LM
    ops = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "send_recv")
    procs = {}
    for op in ops:
        port = str(LM.free_port())
        procs[op] = [subprocess.Popen(
            [sys.executable, "-c", GLOO_PROBE, op, str(r), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
    return procs


def finish_gloo_cuda_probe(procs: dict) -> dict:
    out = {}
    for op, pair in procs.items():
        got = []
        for p in pair:
            try:
                so, se = p.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
            got.append((p.returncode, so.strip().splitlines()[-1:] or [""],
                        se.strip().splitlines()[-1:] or [""]))
        rc, line, err = got[0]
        if all(g[0] == 0 for g in got):
            out[op] = json.loads(line[0])
        else:
            out[op] = f"failed: exit {[g[0] for g in got]}: " \
                      f"{(err[0] or got[1][2][0])[:160]}"
    return out


def mesh_kernel_times(dev) -> dict:
    """The flash and decode kernels at a rank's share of the heads on a model
    axis of 2. ``kernels_at_8_heads``: olmo-1b's 8 of 16 heads of 128 (phase
    10), flash at a bf16 4x2048 causal prefill, decode at bf16 4 slots of a
    1024 buffer with seeded lengths. ``kernels_at_family_ranks``: the
    shapes phase 11 gives them, per model of MESH_FAMILIES that runs
    attention (zamba2-7b's shared block 16 of 32 heads of 112,
    llama-3.2-vision-11b's self-attention 16 on 4 kv of 128, musicgen-large
    16 of 32 of 64): flash at its bf16 4x2048 prefill, decode at its fp32
    ticks (4 slots of a MESH_FAMILY_TICKS buffer). Each wrapper is held
    against its plain version on the same inputs (``TOL`` of the dtype,
    tests/test_kernels.py's allclose; it raises above it), then timed with
    L2 flushed beside its plain version, SDPA on the same inputs, and the
    bound of the same work from ``KernelSpec.cost`` (the kernel table's)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    if dev.type != "cuda":
        return {"kernels_at_8_heads": "not measured (no card)",
                "kernels_at_family_ranks": "not measured (no card)"}
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def randn(*shape, dtype="bfloat16"):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dtype])

    def check(name, got, want, dtype):
        torch.cuda.synchronize()
        rtol, atol = TOL[dtype]
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        if not (bool(torch.isfinite(got).all())
                and torch.allclose(got, want, rtol=rtol, atol=atol)):
            raise AssertionError(
                f"{name} at a rank's heads disagrees with its plain version: "
                f"max_abs_err {err:.3e} (rtol=atol={atol}, {dtype})")
        return err

    def bound(flops, nbytes, dtype):
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def flash_at(h, kv, d):
        """bf16, causal, (PREFILL_BATCH, PREFILL_LEN, H, D) queries."""
        b, s = PREFILL_BATCH, PREFILL_LEN
        q, k, v = randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        row = {
            "shape": [b, s, h, kv, d], "dtype": "bfloat16",
            "max_abs_err": check(
                f"flash_attention h={h} kv={kv} d={d}",
                ops.flash_attention(q, k, v),
                fa.flash_attention_plain(qh, kh, vh).permute(0, 2, 1, 3),
                "bfloat16"),
            "tol": TOL["bfloat16"][1],
            "ms": flushed_ms(lambda: ops.flash_attention(q, k, v), 10, flush),
            "plain_ms": flushed_ms(
                lambda: fa.flash_attention_plain(qh, kh, vh), 10, flush),
            "library_ms": flushed_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=h != kv), 10, flush),
            **bound(*AT.KERNELS["flash_attention"].cost(
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": "bfloat16"}), "bfloat16")}
        del q, k, v, qh, kh, vh
        return row

    def decode_at(h, kv, d, buf, dtype, iters):
        """4 slots of a BUF-long cache with seeded lengths in [1, BUF]."""
        qd = randn(4, 1, h, d, dtype=dtype)
        kc, vc = randn(4, buf, kv, d, dtype=dtype), \
            randn(4, buf, kv, d, dtype=dtype)
        lens = torch.from_numpy(np.random.default_rng(0).integers(
            1, buf + 1, 4).astype(np.int32)).to(dev)
        kh, vh = (t.permute(0, 2, 1, 3) for t in (kc, vc))
        qh = qd.permute(0, 2, 1, 3)                            # (B, H, 1, D)
        mask = (torch.arange(buf, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        row = {
            "shape": [4, buf, h, kv, d], "dtype": dtype,
            "cache_len": lens.tolist(),
            "max_abs_err": check(
                f"decode_attention h={h} kv={kv} d={d} buffer {buf}",
                ops.decode_attention(qd, kc, vc, lens)[:, 0],
                dec.decode_attention_plain(qd[:, 0], kh, vh, lens), dtype),
            "tol": TOL[dtype][1],
            "ms": flushed_ms(lambda: ops.decode_attention(qd, kc, vc, lens),
                             iters, flush),
            "plain_ms": flushed_ms(lambda: dec.decode_attention_plain(
                qd[:, 0], kh, vh, lens), iters, flush),
            "library_ms": flushed_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=h != kv), iters,
                flush),
            **bound(*AT.KERNELS["decode_attention"].cost(
                {"b": 4, "s": buf, "h": h, "kv": kv, "d": d, "dtype": dtype},
                valid=int(lens.sum())), dtype)}
        del qd, kc, vc, qh, kh, vh, mask
        return row

    out = {"kernels_at_8_heads": {"flash": flash_at(8, 8, 128),
                                  "decode": decode_at(8, 8, 128, 1024,
                                                      "bfloat16", 50)},
           "kernels_at_family_ranks": {}}
    for arch in MESH_FAMILIES:
        cfg = get_arch(arch)
        if cfg.family == "ssm":                  # rwkv6-7b: no attention
            continue
        h, kv, d = cfg.n_heads // 2, cfg.n_kv_heads // 2, \
            cfg.resolved_head_dim
        out["kernels_at_family_ranks"][arch] = {
            "of_heads": cfg.n_heads,
            "flash": flash_at(h, kv, d),
            "decode": decode_at(h, kv, d, MESH_FAMILY_TICKS, "float32", 50)}
    del flush
    free()
    return out


def scan_kernel_times(dev) -> dict:
    """The WKV6 and SSD kernels at a rank's share of the heads on a model
    axis of 2 (phase 11's): WKV6 at rwkv6-7b's 32 of 64 heads of 64, SSD at
    zamba2-7b's 56 of 112 heads (P 64, N 64, one group), both bf16 at a
    4x2048 prefill, on the layouts a rank's block hands them (r, k, v and
    the fp32 log decays each a (B, S, 32 * 64) projection; x a
    (B, S, 56 * 64) projection, dt (B, S, 56) fp32, B and C the two halves
    of one (B, S, 2 N) projection, as ``mamba_block`` slices them). Each
    wrapper is held against its plain version on the same inputs
    (``TOL["bfloat16"]``, tests/test_kernels.py's allclose; it raises above
    it), then timed with L2 flushed beside its plain version and the bound
    of the same work from ``KernelSpec.cost`` (the kernel table's); no
    single PyTorch call computes either scan."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wkv
    if dev.type != "cuda":
        return {"wkv6": "not measured (no card)",
                "mamba2_ssd": "not measured (no card)"}
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    rtol, atol = TOL["bfloat16"]
    b, s = PREFILL_BATCH, PREFILL_LEN

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def check(name, got, want):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        if not (bool(torch.isfinite(got).all())
                and torch.allclose(got, want, rtol=rtol, atol=atol)):
            raise AssertionError(
                f"{name} at a rank's heads disagrees with its plain version: "
                f"max_abs_err {err:.3e} (rtol=atol={atol})")
        return err

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], \
            nbytes / HBM_BYTES_PER_S
        return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    h, k = 32, 64
    r, kk, v = (randn(b, s, h * k, scale=0.5).view(b, s, h, k)
                for _ in range(3))
    logw = -torch.exp(-7.0 + 6.3 * torch.rand((b, s, h * k), generator=gen,
                                              device=dev)).view(b, s, h, k)
    u = randn(h, k, scale=0.3, dtype=torch.float32)
    bhsk = [t.permute(0, 2, 1, 3) for t in (r, kk, v, logw)]
    out = {"wkv6": {
        "shape": [b, s, h, k], "of_heads": 64,
        "max_abs_err": check("wkv6", ops.wkv6(r, kk, v, logw, u),
                             wkv.wkv6_plain(*bhsk, u).permute(0, 2, 1, 3)),
        "tol": atol,
        "ms": flushed_ms(lambda: ops.wkv6(r, kk, v, logw, u), 10, flush,
                         per_call=1),
        "plain_ms": flushed_ms(lambda: wkv.wkv6_plain(*bhsk, u), 3, flush),
        "library_ms": None,
        **bound(*AT.KERNELS["rwkv6"].cost(
            {"b": b, "s": s, "h": h, "k": k, "dtype": "bfloat16"}))}}
    del r, kk, v, logw, u, bhsk

    h, p, n = 56, 64, 64
    x = randn(b, s, h * p, scale=0.5).view(b, s, h, p)
    dtv = F.softplus(randn(b, s, h, dtype=torch.float32) - 1.0)
    A = -torch.exp(randn(h, scale=0.3, dtype=torch.float32))
    bc = randn(b, s, 2 * n, scale=0.5)
    Bm, Cm = bc[..., :n].view(b, s, 1, n), bc[..., n:].view(b, s, 1, n)
    Dv = torch.ones(h, device=dev)
    args = (x, dtv, A, Bm, Cm, Dv)
    plain = (x.permute(0, 2, 1, 3), dtv.permute(0, 2, 1), A,
             Bm.permute(0, 2, 1, 3), Cm.permute(0, 2, 1, 3), Dv)
    out["mamba2_ssd"] = {
        "shape": [b, s, h, p, 1, n], "of_heads": 112,
        "max_abs_err": check("mamba2_ssd", ops.mamba2_ssd(*args),
                             ssd.ssd_plain(*plain).permute(0, 2, 1, 3)),
        "tol": atol,
        "ms": flushed_ms(lambda: ops.mamba2_ssd(*args), 10, flush,
                         per_call=1),
        "plain_ms": flushed_ms(lambda: ssd.ssd_plain(*plain), 3, flush),
        "library_ms": None,
        **bound(*AT.KERNELS["mamba2_ssd"].cost(
            {"b": b, "s": s, "h": h, "p": p, "n": n, "g": 1,
             "dtype": "bfloat16"}))}
    del x, dtv, A, bc, Bm, Cm, Dv, args, plain, flush
    free()
    return out


def kvseq_kernel_times(dev) -> dict:
    """The decode kernel where phase 12 runs it: bf16, batch 1, with
    ``return_lse`` at a rank's shard of KVSEQ_BUF / 2 positions (every one
    valid) at qwen3-8b's heads (32 on 8 kv heads of 128) and zamba2-7b's
    shared block's (32 on 32 of 112), and at the same heads without it over
    the whole KVSEQ_BUF buffer, for comparison. Each is held against its
    plain version on the same inputs, then timed with L2 flushed beside its
    plain version, SDPA on the same inputs (its o only) and the bound of the
    same work from ``KernelSpec.cost``. The partial softmax's o and lse are
    fp32 on both sides, computed in fp32 from the same bf16 inputs: held at
    ``TOL["float32"]``. The whole-buffer rows' o is bf16 of a size near
    sqrt(e / S) (scores N(0, 1) spread the softmax over about S / e keys):
    held at rtol 2e-2 and an atol of 1e-4, scaled to it. Each check must
    also refuse the plain version over 90% of the positions, a kernel that
    skipped a tenth of them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.provision import autotune as AT
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    if dev.type != "cuda":
        return {"at_kvseq": "not measured (no card)"}
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for arch in ("qwen3-8b", "zamba2-7b"):
        cfg = get_arch(arch)
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        for s, lse in ((KVSEQ_BUF // 2, True), (KVSEQ_BUF, False)):
            q = torch.randn((1, 1, h, d), generator=gen, device=dev).to(
                torch.bfloat16)
            kc, vc = (torch.randn((1, s, kv, d), generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            lens = torch.full((1,), s, dtype=torch.int32, device=dev)
            kh, vh = (t.permute(0, 2, 1, 3) for t in (kc, vc))
            qh = q.permute(0, 2, 1, 3)
            got = ops.decode_attention(q, kc, vc, lens, return_lse=lse)
            want = dec.decode_attention_plain(q[:, 0], kh, vh, lens,
                                              return_lse=lse)
            torch.cuda.synchronize()
            short = dec.decode_attention_plain(q[:, 0], kh, vh,
                                               lens * 9 // 10,
                                               return_lse=lse)
            rtol, atol = TOL["float32"] if lse else (2e-2, 1e-4)
            pairs = [(got[0][:, 0], want[0], short[0]),
                     (got[1], want[1], short[1])] if lse \
                else [(got[:, 0], want, short)]
            err = 0.0
            for g, w, sh in pairs:
                g, w = g.float(), w.float()
                err = max(err, (g - w).abs().max().item())
                if not (bool(torch.isfinite(g).all())
                        and torch.allclose(g, w, rtol=rtol, atol=atol)):
                    raise AssertionError(
                        f"decode attention (return_lse={lse}) at {arch}'s "
                        f"heads over {s} positions disagrees with its plain "
                        f"version: max_abs_err {err:.3e}")
                if torch.allclose(sh.float(), w, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"decode attention's check at {arch}'s heads over "
                        f"{s} positions (rtol {rtol}, atol {atol}) passes "
                        "the plain version over 90% of them")
            key = f"at_{arch.replace('-', '_')}_" + (
                f"kvseq_shard_of_{s}" if lse else f"whole_{s}")
            out[key] = {
                "shape": [1, s, h, kv, d], "dtype": "bfloat16",
                "return_lse": lse, "cache_len": [s], "max_abs_err": err,
                "tol": atol, "rtol": rtol,
                "ms": flushed_ms(lambda: ops.decode_attention(
                    q, kc, vc, lens, return_lse=lse), 50, flush),
                "plain_ms": flushed_ms(lambda: dec.decode_attention_plain(
                    q[:, 0], kh, vh, lens, return_lse=lse), 20, flush),
                "library_ms": flushed_ms(
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, enable_gqa=h != kv), 50, flush)}
            flops, nbytes = AT.KERNELS["decode_attention"].cost(
                {"b": 1, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": "bfloat16"}, valid=s)
            t_ops = flops / PEAK_FLOPS["bfloat16"]
            t_bytes = nbytes / HBM_BYTES_PER_S
            out[key].update(bound_ms=max(t_ops, t_bytes) * 1e3,
                            bound_by="operations" if t_ops >= t_bytes
                            else "bytes")
            del q, kc, vc, kh, vh, qh, got, want, short
    del flush
    free()
    return out


def _mesh_rank(rank: int, world: int, part: str, outdir: str,
               init_method: str, device: str) -> None:
    """One of phase 10's two gloo ranks on the card: part "tp" on a (1, 2)
    mesh (serving, the fp32 checks, compressed_psum, GPipe, a save), part
    "fsdp" on (2, 1) (the train step); the readings to OUTDIR/PART.RANK.json.
    ``device`` is "cuda" (the CPU only in a rehearsal)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the dry-run's count of (2)'s train step, before this process has a
    # process group (a count starts a fake one of its own)
    count = mesh_tp_train_count(device) if part == "tp" and rank == 0 \
        else None
    dev = LM.init_rank(rank, world, backend="gloo", device=device,
                       init_method=init_method)
    try:
        _reset_peak(dev)
        res = (_mesh_tp if part == "tp" else _mesh_fsdp)(rank, dev)
        if count is not None:
            res["train"]["count"] = count
        res["rank"] = rank        # "fsdp": (a)'s peak, its steps' own
        res.setdefault("peak_gb", _peak_gb(dev))
        Path(outdir, f"{part}.{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _range_err(got, want) -> float:
    """max|got - want| over the range of want."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / (want.max() - want.min())).item()


def _mesh_tp(rank: int, dev) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.core.acai import AcaiProject
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as L
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.sharding import spmd as S
    from repro_torch.train import compression as C
    from repro_torch.train import pipeline as PP
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoints import CheckpointManager

    mesh = LM.make_mesh((1, 2), ("data", "model"), device_type=dev.type)
    counters = launch_counters()
    heads = {"flash_attention": set(), "decode_attention": set()}
    for name in heads:                   # the heads each launch sees
        orig = getattr(ops, name)

        def seen(q, *a, orig=orig, name=name, **kw):
            heads[name].add(int(q.shape[2]))      # q: (B, S, H, D)
            return orig(q, *a, **kw)
        setattr(ops, name, seen)
    res, gates = {"train": _mesh_tp_train(rank, mesh, dev)}, {}

    # olmo-1b uncut in bf16: three 4x2048 prefills, then 4 requests served
    cfg = get_arch("olmo-1b")
    full = M.cast_params(weights(cfg, dev), torch.bfloat16)
    _, pspecs, _ = TS.sharded_specs(cfg, mesh)
    params = S.distribute(full, pspecs, mesh)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)))
    prefill = D.make_sharded_prefill_step(cfg, mesh, device=dev)
    for c in counters.values():
        c.launches = 0
    ms = []
    for _ in range(3):                   # the first call warms up
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    flash = counters["flash_attention"].launches
    # the MESH_REQUESTS shortest of phase 5's 8 requests (162 tokens: 193
    # ticks; the ranks' ticks take about 112 ms on one card)
    prompts = sorted(slice_prompts(cfg, SLICES["olmo-1b"]),
                     key=len)[:MESH_REQUESTS]
    slots, buf, _, max_new, _ = SLICES["olmo-1b"]
    served = L.serve(cfg, params, prompts, slots=slots, buf=buf,
                     max_new=max_new, device=dev, mesh=mesh)
    launches = {k: c.launches for k, c in counters.items()}
    res.update(launches=launches, prefill_ms=ms, ticks=served.ticks,
               ms_per_tick=1e3 * served.seconds / served.ticks,
               heads={k: sorted(v) for k, v in heads.items()})
    gates["flash launches a prefill call"] = [abs(flash / 3 - 16), 0]
    gates["decode launches a tick"] = [
        abs(launches["decode_attention"] / served.ticks - 16), 0]
    gates["heads a launch"] = [
        abs(len(set().union(*heads.values())) - 1)
        + abs(next(iter(heads["flash_attention"])) - 8), 0]
    for r, p in enumerate(prompts):       # serving against the mesh prefill
        want = prefill(params, {"tokens": torch.tensor([p])})[0]
        gates[f"request {r} served logits (bf16)"] = [
            _range_err(served.first_logits[r], want), 5e-2]
    if rank == 0:                         # the one-rank (one-device) prefill
        want = D.make_prefill_step(cfg, device=dev)(full,
                                                    {"tokens": tokens})
        gates["prefill logits (bf16) against one rank"] = [
            _range_err(logits, want), 5e-2]
    del full, params, prefill, logits
    free()

    # fp32 at 2 layers: the sharded prefill against one rank's, and a save
    cfg2 = dataclasses.replace(cfg, n_layers=MESH_FP32_LAYERS)
    full = weights(cfg2, dev)
    params = S.distribute(full, TS.sharded_specs(cfg2, mesh)[1], mesh)
    logits = D.make_sharded_prefill_step(cfg2, mesh, device=dev,
                                         compute_dtype=torch.float32)(
        params, {"tokens": tokens})
    root = ROOT / "build" / "mesh-lake"
    ckpt = CheckpointManager(AcaiProject("mesh", root) if rank == 0
                             else None, "mesh", mesh=mesh)
    t0 = time.perf_counter()
    ckpt.save(1, params)
    res["save_s"] = time.perf_counter() - t0
    if rank == 0:
        want = D.make_prefill_step(cfg2, device=dev,
                                   compute_dtype=torch.float32)(
            full, {"tokens": tokens})
        gates["prefill logits (fp32, 2 layers) against one rank"] = [
            _range_err(logits, want), 1e-3]
        back, _ = CheckpointManager(AcaiProject("mesh", root), "mesh"
                                    ).restore({"params": full})
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(back["params"]), _leaves(full)))
        gates["restored on one rank, bit for bit (0 = equal)"] = [
            0 if same else 1, 0]
        import shutil
        shutil.rmtree(root)
    del full, params, logits
    free()

    # olmoe-1b-7b, 2 layers, expert parallel at the no-drop capacity, fp32
    cfg3 = no_drop(dataclasses.replace(get_arch("olmoe-1b-7b"),
                                       n_layers=MESH_MOE_LAYERS))
    full = weights(cfg3, dev)
    params = S.distribute(full, TS.sharded_specs(cfg3, mesh)[1], mesh)
    toks3 = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg3.vocab_size, MESH_MOE_BATCH))
    logits = D.make_sharded_prefill_step(cfg3, mesh, device=dev,
                                         compute_dtype=torch.float32)(
        params, {"tokens": toks3})
    res["moe_local_experts"] = S.to_local(params)["layers"]["moe"][
        "w_gate"].shape[1]
    if rank == 0:
        want = D.make_prefill_step(cfg3, device=dev,
                                   compute_dtype=torch.float32)(
            full, {"tokens": toks3})
        gates["olmoe EP prefill (fp32) against the no-mesh branch"] = [
            _range_err(logits, want), 1e-3]
    del full, params, logits
    free()

    # compressed_psum and a 2-stage GPipe on the card's tensors
    world = dist.group.WORLD
    xs = [torch.from_numpy(np.random.default_rng(30 + r).standard_normal(
        (1024, 257)).astype(np.float32)).to(dev) for r in range(2)]
    for kind in ("bf16", "int8"):
        got = C.compressed_psum(xs[rank], world, kind)
        want = C.decompress(*C.compress(xs[0], kind)) \
            + C.decompress(*C.compress(xs[1], kind))
        gates[f"compressed_psum {kind} (0 = bit-equal)"] = [
            0 if torch.equal(got, want) else 1, 0]
    rng = np.random.default_rng(31)
    stacked = {"w": torch.from_numpy((rng.standard_normal((2, 256, 256))
                                      / 16).astype(np.float32)).to(dev),
               "b": torch.from_numpy(rng.standard_normal((2, 256)).astype(
                   np.float32)).to(dev)}
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(
        np.float32)).to(dev)

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    y = PP.pipeline_apply(stage, {k: v[rank:rank + 1]
                                  for k, v in stacked.items()}, x,
                          group=world, n_microbatches=8)
    gates["GPipe (2 stages) against sequential_apply"] = [
        (y - PP.sequential_apply(stage, stacked, x)).abs().max().item(),
        1e-5]
    res["gates"] = gates
    return res


def mesh_tp_train_cell():
    """Phase 10 (2)'s train steps: (config, ShapeConfig, TrainConfig,
    OptimizerConfig, batches), olmo-1b at full width and
    MESH_TP_TRAIN_LAYERS layers, fp32, remat full, phase 10's
    MESH_TRAIN_STEPS 4x2048 batches."""
    from repro_torch.configs.shapes import ShapeConfig
    cfg, tcfg, ocfg, batches = mesh_train_setup(None)
    cfg = dataclasses.replace(cfg, n_layers=MESH_TP_TRAIN_LAYERS)
    return (cfg, ShapeConfig("train", TRAIN_LEN, TRAIN_BATCH, "train"),
            tcfg, ocfg, batches)


def mesh_tp_train_count(device: str) -> dict:
    """The dry-run's count of phase 10 (2)'s train step on a fake (1, 2)
    mesh (fake tensors of ``device``): a rank's arguments, the step's own
    peak of live bytes, their sum (the predicted peak), the count's
    seconds. Run in a process without a process group."""
    from repro_torch.launch import dryrun as DR
    cfg, shape, tcfg, _, _ = mesh_tp_train_cell()
    got = DR.count_cell(cfg, shape, (1, 2), tcfg=tcfg, device=device)
    return {"args_bytes": got["args_bytes"],
            "temp_bytes": got["cost"].peak_bytes,
            "peak_bytes": got["args_bytes"] + got["cost"].peak_bytes,
            "count_s": got["seconds"],
            "collectives": got["cost"].coll_count}


def _mesh_tp_train(rank: int, mesh, dev) -> dict:
    """Phase 10 (2)'s train steps on the (1, 2) mesh: each rank its vocab
    columns of the logits, the loss's row max and sums all-reduced over
    "model" (``model.vocab_sharded_nll``); each step's loss, grad norm
    and ms, and this rank's peak (reset after its state is built, as the
    dry-run counts the arguments and the step's own bytes; the first
    step's is the one the count holds); rank 0 then runs the one-device
    steps on the same init and batches."""
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    cfg, _, tcfg, ocfg, batches = mesh_tp_train_cell()
    specs = TS.sharded_specs(cfg, mesh)
    params, opt = TS.shard_train_state(M.init_params(cfg, 0, device=dev),
                                       tcfg, *specs[1:], mesh)
    free()
    step = TS.make_sharded_train_step(cfg, tcfg, ocfg, mesh, device=dev,
                                      specs=specs)
    _sync(dev)
    _reset_peak(dev)
    got = _mesh_steps(step, params, opt, batches, dev)
    del step, params, opt
    free()
    if rank == 0:
        params = M.init_params(cfg, 0, device=dev)
        got["one_device"] = _mesh_steps(
            TS.make_train_step(cfg, tcfg, ocfg, device=dev), params,
            TS.make_opt_state(params, tcfg), batches, dev)
        del params
        free()
    got["layers"] = cfg.n_layers
    return got


def _mesh_fsdp(rank: int, dev) -> dict:
    """Phase 10's (3): (a) the FSDP and ZeRO-1 train steps on (2, 1), each
    layer gathered over data where it runs; (b) the first batch's step at
    2 microbatches; (c) a (2, 1, 1) ("pod", "data", "model") mesh: the
    first step, then serving (``_mesh_pod_serve``)."""
    from repro_torch.launch import mesh as LM
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.models import model as M
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS
    mesh = LM.make_mesh((2, 1), ("data", "model"), device_type=dev.type)
    cfg, tcfg, ocfg, batches = mesh_train_setup(dev)

    def fresh(tc, on):
        step, pspecs, ospecs = build_sharded_train(cfg, tc, ocfg, on,
                                                   device=dev)
        params, opt = TS.shard_train_state(M.init_params(cfg, 0, device=dev),
                                           tc, pspecs, ospecs, on)
        free()
        return step, params, opt

    step, params, opt = fresh(tcfg, mesh)
    shard_gb = {k: sum(t.numel() * t.element_size()
                       for t in _leaves(S.to_local(tree))) / 1e9
                for k, tree in (("params", params), ("mu", opt["mu"]))}
    res = _mesh_steps(step, params, opt, batches, dev)
    res["local_gb"] = shard_gb
    del step, params, opt
    free()
    _reset_peak(dev)
    res["mb2"] = _mesh_steps(*fresh(dataclasses.replace(
        tcfg, microbatches=2), mesh), batches[:1], dev)
    free()
    pod = LM.make_mesh((2, 1, 1), ("pod", "data", "model"),
                       device_type=dev.type)
    _reset_peak(dev)
    res["pod"] = _mesh_steps(*fresh(tcfg, pod), batches[:1], dev)
    free()
    res.update(_mesh_pod_serve(rank, pod, dev))
    return res


def _mesh_pod_serve(rank: int, pod, dev) -> dict:
    """Phase 10's (c), serving on the (2, 1, 1) mesh: olmo-1b at full width
    and MESH_POD_LAYERS layers, the "fsdp" layout at batch 4 (2 rows a
    rank, over "pod"): a fp32 prefill and MESH_POD_TICKS fp32
    teacher-forced ticks against one rank's (rank 0, the one-device
    port); then a bf16 4x2048 prefill and MESH_POD_TICKS bf16 ticks,
    whose launches (flash once a layer a call, decode once a layer a
    tick, each at the rank's 2 rows) count in the kernel table's
    main-path launches; the bf16 prefill against one rank's."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=MESH_POD_LAYERS)
    b, ticks, f32 = PREFILL_BATCH, MESH_POD_TICKS, torch.float32
    full = weights(cfg, dev)
    pspecs = TS.sharded_specs(cfg, pod)[1]
    rng = np.random.default_rng(22)
    small = torch.from_numpy(rng.integers(0, cfg.vocab_size, MESH_POD_FP32))
    large = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (b, PREFILL_LEN)))
    gates, res = {}, {}

    def run(params, dtype, tokens, one: bool):
        """(prefill logits, ticks' logits (B, ticks, V)) on the pod mesh,
        or of one rank (the one-device port) with ``one``."""
        if one:
            pre = D.make_prefill_step(cfg, compute_dtype=dtype, device=dev)
            step = D.make_serve_step(cfg, ticks, compute_dtype=dtype,
                                     device=dev)
            from repro_torch.models import transformer as T
            states = T.init_decode_state(cfg, b, ticks, dtype=dtype,
                                         device=dev)
        else:
            pre = D.make_sharded_prefill_step(cfg, pod, compute_dtype=dtype,
                                              device=dev)
            step = D.make_sharded_serve_step(cfg, pod, ticks,
                                             compute_dtype=dtype, device=dev)
            states = D.init_sharded_decode_state(cfg, pod, b, ticks,
                                                 dtype=dtype, device=dev)
        logits = pre(params, {"tokens": tokens})
        got = []
        for i in range(ticks):
            out, states, _ = step(params, states, {
                "tokens": tokens[:, i:i + 1],
                "cache_len": torch.full((b,), i, dtype=torch.int32)})
            got.append(out[:, 0])
        _sync(dev)
        return logits, torch.stack(got, 1)

    params = S.distribute(full, pspecs, pod)
    pre32, ticks32 = run(params, f32, small, one=False)
    if rank == 0:
        want_pre, want_ticks = run(full, f32, small, one=True)
        gates["fp32 prefill against one rank"] = [
            _range_err(pre32, want_pre), 1e-3]
        gates["fp32 ticks against one rank"] = [
            max(_range_err(ticks32[:, t], want_ticks[:, t])
                for t in range(ticks)), 1e-3]
    del params
    free()

    full = M.cast_params(full, torch.bfloat16)
    params = S.distribute(full, pspecs, pod)
    rows = {"flash_attention": set(), "decode_attention": set()}
    origs = {name: getattr(ops, name) for name in rows}
    for name, orig in origs.items():       # the rows each launch sees

        def seen(q, *a, orig=orig, name=name, **kw):
            rows[name].add(int(q.shape[0]))       # q: (B, S, H, D)
            return orig(q, *a, **kw)
        setattr(ops, name, seen)
    counters = launch_counters()
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        pre16, _ = run(params, torch.bfloat16, large, one=False)
        res["bf16_prefill_and_ticks_ms"] = 1e3 * (time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        for name, orig in origs.items():
            setattr(ops, name, orig)
    res.update(launches=launches, rows={k: sorted(v)
                                        for k, v in rows.items()})
    gates["flash launches a prefill call"] = [
        abs(launches["flash_attention"] - MESH_POD_LAYERS), 0]
    gates["decode launches a tick"] = [
        abs(launches["decode_attention"] / ticks - MESH_POD_LAYERS), 0]
    gates["rows a launch"] = [abs(len(set().union(*rows.values())) - 1)
                              + abs(max(rows["decode_attention"]) - b // 2),
                              0]
    gates["other kernels launched"] = [
        sum(n for k, n in launches.items() if k not in rows), 0]
    if rank == 0:
        want = D.make_prefill_step(cfg, device=dev)(full, {"tokens": large})
        gates["bf16 prefill against one rank"] = [_range_err(pre16, want),
                                                  5e-2]
    del full, params
    free()
    res["gates"] = gates
    return res


def run_mesh_families(card, dev) -> dict:
    """Phase 11 (see the module docstring): two spawned gloo ranks on the
    card, mesh (1, 2), each writing its readings to a file that this
    process reads and gates."""
    import tempfile

    from repro_torch.launch import mesh as LM
    t0 = time.perf_counter()
    out = {"card": card, "gates": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        LM.run_ranks(_families_rank, 2, (tmp, "tcp://localhost:"
                                         f"{LM.free_port()}", dev.type))
        ranks = [json.loads(Path(tmp, f"families.{r}.json").read_text())
                 for r in range(2)]
    for r, rank in enumerate(ranks):
        for name, (value, limit) in rank["gates"].items():
            out["gates"][f"rank {r} {name}"] = [value, limit]
            if not value <= limit:
                raise AssertionError(f"mesh families: rank {r} {name} "
                                     f"{value:.3e} > {limit:.3e}")
    out["ranks"] = ranks
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = MESH_FAMILIES_BUDGET_S
    return out


def _families_rank(rank: int, world: int, outdir: str, init_method: str,
                   device: str) -> None:
    """One of phase 11's two gloo ranks on the card; its readings to
    OUTDIR/families.RANK.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = LM.init_rank(rank, world, backend="gloo", device=device,
                       init_method=init_method)
    try:
        _reset_peak(dev)
        res = _mesh_families(rank, dev)
        res["rank"] = rank
        Path(outdir, f"families.{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh_families(rank: int, dev) -> dict:
    """Each of MESH_FAMILIES at full width and cut depth on a (1, 2) mesh,
    against the one-device port on rank 0: fp32 then bf16 (the weights are
    cast in place between), the one-device runs before the sharded ones so
    that each sharded run's peak holds this rank's shards alone."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig

    mesh = LM.make_mesh((1, 2), ("data", "model"), device_type=dev.type)
    counters = launch_counters()
    heads = {}
    for name in counters:                # the heads each launch sees
        orig = getattr(ops, name)

        def seen(q, *a, orig=orig, name=name, **kw):
            heads.setdefault(name, set()).add(int(q.shape[2]))  # (B, S, H, .)
            return orig(q, *a, **kw)
        setattr(ops, name, seen)
    f32, b16 = torch.float32, torch.bfloat16
    res, gates, launches = {"models": {}}, {}, dict.fromkeys(counters, 0)
    peak = 0.0                        # the phase's, across the resets below

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        got = fn()
        _sync(dev)
        return got, 1e3 * (time.perf_counter() - t0)

    def ticks(step, params, states, batch):
        """MESH_FAMILY_TICKS teacher-forced ticks of ``batch``'s tokens:
        (logits (B, T, ...), ms a tick)."""
        got, ms = [], []
        for i in range(MESH_FAMILY_TICKS):
            cl = torch.full((batch["tokens"].shape[0],), i,
                            dtype=torch.int32)
            (logits, states, _), t = timed(lambda: step(params, states, {
                **batch, "tokens": batch["tokens"][:, i:i + 1],
                "cache_len": cl}))
            got.append(logits[:, 0].float().cpu())
            ms.append(t)
        return torch.stack(got, 1), ms

    for arch, layers in MESH_FAMILIES.items():
        start = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        per_call, _ = launches_per_call(cfg)
        rng = np.random.default_rng(40)
        small = model_batch(cfg, rng, *MESH_FAMILY_FP32)
        large = model_batch(cfg, rng, PREFILL_BATCH, PREFILL_LEN)
        vision = small.get("vision")
        one = rank == 0
        row, want = {"layers": layers}, {}
        full = weights(cfg, dev)                          # fp32
        _, pspecs, _ = TS.sharded_specs(cfg, mesh)

        # fp32: the one-device runs on rank 0, then the sharded ones
        if one:
            want["p32"], row["one_prefill32_ms"] = timed(
                lambda: D.make_prefill_step(cfg, compute_dtype=f32,
                                            device=dev)(full, small))
            want["ticks"], tick_ms = ticks(
                D.make_serve_step(cfg, MESH_FAMILY_TICKS, compute_dtype=f32,
                                  device=dev), full, T.init_decode_state(
                    cfg, PREFILL_BATCH, MESH_FAMILY_TICKS, dtype=f32,
                    device=dev, vision=vision, params=full), small)
            row["one_tick32_ms"] = sum(tick_ms[1:]) / len(tick_ms[1:])
            want["l32"] = D.make_prefill_step(
                cfg, compute_dtype=f32, device=dev)(full, large).float().cpu()
            free()
        params = S.distribute(full, pspecs, mesh)
        got32, row["prefill32_ms"] = timed(lambda: D.make_sharded_prefill_step(
            cfg, mesh, compute_dtype=f32, device=dev)(params, small))
        got_ticks, tick_ms = ticks(
            D.make_sharded_serve_step(cfg, mesh, MESH_FAMILY_TICKS,
                                      compute_dtype=f32, device=dev),
            params, D.init_sharded_decode_state(
                cfg, mesh, PREFILL_BATCH, MESH_FAMILY_TICKS, dtype=f32,
                device=dev, vision=vision, params=params), small)
        row["tick32_ms"] = sum(tick_ms[1:]) / len(tick_ms[1:])
        if one:
            gates[f"{arch} prefill (fp32, 4x512) against one device"] = [
                _range_err(got32, want["p32"]), 1e-3]
            gates[f"{arch} {MESH_FAMILY_TICKS} ticks (fp32) against one "
                  "device"] = [_range_err(got_ticks, want["ticks"]), 1e-3]
        del params, got32, got_ticks
        free()
        if cfg.family == "hybrid":        # one fp32 train step
            tcfg = TS.TrainConfig(remat="full", compute_dtype="float32")
            ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
            toks = small["tokens"]
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if one:
                p1 = _to(full, dev)
                _, _, m = TS.make_train_step(cfg, tcfg, ocfg, device=dev)(
                    p1, TS.make_opt_state(p1, tcfg), batch)
                want["train"] = float(m["loss"])
                del p1, m
                free()
            specs = TS.sharded_specs(cfg, mesh)
            dp, opt = TS.shard_train_state(full, tcfg, *specs[1:], mesh)
            (_, _, m), row["train_step_ms"] = timed(
                lambda: TS.make_sharded_train_step(
                    cfg, tcfg, ocfg, mesh, device=dev, specs=specs)(
                    dp, opt, batch))
            row["train_loss"] = float(m["loss"])
            if one:
                gates[f"{arch} train step loss (fp32, 4x512), relative"] = [
                    abs(row["train_loss"] - want["train"])
                    / abs(want["train"]), 1e-4]
            del dp, opt, m
            free()

        # bf16 at 4x2048: the one-device prefill, then two sharded calls
        M.cast_params(full, b16)
        if one:
            want["l16"], row["one_prefill16_ms"] = timed(
                lambda: D.make_prefill_step(cfg, device=dev)(
                    full, large).float().cpu())
        params = S.distribute(full, pspecs, mesh)
        del full
        free()
        peak = max(peak, _peak_gb(dev))
        _reset_peak(dev)
        prefill = D.make_sharded_prefill_step(cfg, mesh, device=dev)
        for c in counters.values():
            c.launches = 0
        heads.clear()
        ms = []
        for _ in range(2):                 # the first call warms up
            got16, t = timed(lambda: prefill(params, large))
            ms.append(t)
        row["prefill16_ms"] = ms
        row["prefill16_peak_gb"] = _peak_gb(dev)
        row["launches"] = {k: c.launches for k, c in counters.items()}
        row["heads"] = {k: sorted(v) for k, v in heads.items()}
        for k, n in row["launches"].items():
            launches[k] += n
        want_heads = {k: [_rank_heads(cfg, k)] for k in per_call}
        gates[f"{arch} launches a bf16 prefill call"] = [sum(
            abs(row["launches"][k] / 2 - per_call.get(k, 0))
            for k in counters), 0]
        gates[f"{arch} heads a launch (0 = the rank's)"] = [
            0 if row["heads"] == want_heads else 1, 0]
        if not bool(torch.isfinite(got16).all()):
            raise AssertionError(f"{arch}: non-finite sharded bf16 logits")
        if one:
            err = (got16.float().cpu() - want["l16"]).abs().max().item()
            rounding = (want["l16"] - want["l32"]).abs().max().item()
            span = (want["l16"].max() - want["l16"].min()).item()
            row["bf16_rounding_error"] = rounding
            gates[f"{arch} prefill (bf16, 4x2048) against one device"] = [
                err, max(5e-2 * span, 2 * rounding)]
        del params, prefill, got16, want
        free()
        row["seconds"] = time.perf_counter() - start
        res["models"][arch] = row
    res["launches"] = launches
    res["gates"] = gates
    res["peak_gb"] = max(peak, _peak_gb(dev))
    return res


def run_kvseq(card, dev) -> dict:
    """Phase 12 (see the module docstring): two spawned gloo ranks on the
    card, mesh (2, 1), each writing its readings to a file that this
    process reads and gates."""
    import tempfile

    from repro_torch.launch import mesh as LM
    t0 = time.perf_counter()
    out = {"card": card, "gates": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        LM.run_ranks(_kvseq_rank, 2, (tmp, "tcp://localhost:"
                                      f"{LM.free_port()}", dev.type))
        ranks = [json.loads(Path(tmp, f"kvseq.{r}.json").read_text())
                 for r in range(2)]
    for r, rank in enumerate(ranks):
        for name, (value, limit) in rank["gates"].items():
            out["gates"][f"rank {r} {name}"] = [value, limit]
            if not value <= limit:
                raise AssertionError(f"kvseq: rank {r} {name} "
                                     f"{value:.3e} > {limit:.3e}")
    out["ranks"] = ranks
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = KVSEQ_BUDGET_S
    return out


def _kvseq_rank(rank: int, world: int, outdir: str, init_method: str,
                device: str) -> None:
    """One of phase 12's two gloo ranks on the card; its readings to
    OUTDIR/kvseq.RANK.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = LM.init_rank(rank, world, backend="gloo", device=device,
                       init_method=init_method)
    try:
        _reset_peak(dev)
        res = _kvseq(rank, dev)
        res["rank"] = rank
        Path(outdir, f"kvseq.{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _seeded_state(cfg, b: int, dtype, dev):
    """The whole decode state of ``b`` rows and KVSEQ_BUF positions in
    ``dtype`` (the SSM state fp32, as ``init_decode_state`` keeps it), each
    leaf 0.5 N(0, 1) in fp32 from seed 12 on the card, then rounded to its
    dtype: the same values on every rank, which then takes its shard, and
    the bf16 state the fp32 one rounded."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.sharding import spmd as S
    gen = torch.Generator(device=dev).manual_seed(12)
    state = T.init_decode_state(cfg, b, KVSEQ_BUF, dtype=dtype, device=dev)
    return S.map_tree(lambda t: (0.5 * torch.randn(
        t.shape, generator=gen, device=dev)).to(t.dtype), state)


def _kvseq(rank: int, dev) -> dict:
    """Each of KVSEQ_RUNS at full width on a (2, 1) mesh under the
    "resident" serving layout (the params replicated, no FSDP gather; at
    batch 1 the "fsdp" layout gives the same decode state specs, and its
    per-call gather of the params through gloo's host memory would take
    seconds a tick), each KV cache's sequence over ("data", "model"): a
    rank holds KVSEQ_BUF / 2 positions. fp32 then bf16 (the weights cast in
    place between); the one-device ticks before the sharded ones."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as D
    from repro_torch.sharding import rules as SR
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS

    mesh = LM.make_mesh((2, 1), ("data", "model"), device_type=dev.type)
    counters = launch_counters()
    positions = set()
    orig = ops.decode_attention

    def seen(q, kc, *a, **kw):
        positions.add(int(kc.shape[1]))                   # (B, S, KV, D)
        return orig(q, kc, *a, **kw)
    ops.decode_attention = seen
    f32, b16 = torch.float32, torch.bfloat16
    res, gates, launches = {"models": {}}, {}, dict.fromkeys(counters, 0)
    peak = 0.0

    def ticks(step, params, states, tokens, starts):
        """KVSEQ_TICKS teacher-forced ticks: (logits (B, T, V) on the host,
        ms a tick)."""
        got, ms = [], []
        for i in range(KVSEQ_TICKS):
            _sync(dev)
            t0 = time.perf_counter()
            logits, states, _ = step(params, states, {
                "tokens": tokens[:, i:i + 1], "cache_len": starts + i})
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            got.append(logits[:, 0].float().cpu())
        return torch.stack(got, 1), ms

    def caches(states):
        return [t for key in T.kv_cache_keys(cfg) for t in states[key]]

    for arch, (layers, b) in KVSEQ_RUNS.items():
        start = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
        one = rank == 0
        row = {"layers": layers, "batch": b}
        rules = SR.AxisRules.for_mesh(mesh)
        specs = SR.decode_state_specs(cfg, b, rules, layout="resident")
        row["kv_spec"] = specs[T.kv_cache_keys(cfg)[0]][0]
        tokens = torch.from_numpy(np.random.default_rng(13).integers(
            0, cfg.vocab_size, (b, KVSEQ_TICKS)))
        starts = torch.tensor(KVSEQ_STARTS[:b], dtype=torch.int32)
        full = weights(cfg, dev)                              # fp32
        pspecs = TS.sharded_specs(cfg, mesh, fsdp=False)[1]
        want = {}
        for name, dt in (("fp32", f32), ("bf16", b16)):
            if dt == b16:
                M.cast_params(full, b16)
            whole = _seeded_state(cfg, b, dt, dev)
            states = D.init_sharded_decode_state(
                cfg, mesh, b, KVSEQ_BUF, dtype=dt, device=dev,
                layout="resident")
            S.map_tree(lambda t, w, sp: t.to_local().copy_(
                S.shard_of(w, sp, mesh)), states, whole, specs)
            if name == "fp32" or one:          # the one-device ticks
                want[name], ms = ticks(D.make_serve_step(
                    cfg, KVSEQ_BUF, compute_dtype=dt, device=dev), full,
                    whole, tokens, starts)
                row[f"one_tick_{name}_ms"] = sum(ms[1:]) / len(ms[1:])
            params = S.distribute(full, pspecs, mesh)
            step = D.make_sharded_serve_step(cfg, mesh, KVSEQ_BUF,
                                             compute_dtype=dt, device=dev,
                                             layout="resident")
            peak = max(peak, _peak_gb(dev))
            _reset_peak(dev)
            for c in counters.values():
                c.launches = 0
            positions.clear()
            with S.watch_collectives() as moved:
                got, ms = ticks(step, params, states, tokens, starts)
            row[f"tick_{name}_ms"] = sum(ms[1:]) / len(ms[1:])
            row[f"{name}_peak_gb"] = _peak_gb(dev)
            shard = caches(S.to_local(states))
            layer = shard[0].shape[-4:]                      # (B, S, KV, D)
            layer_bytes = int(np.prod(layer)) * shard[0].element_size()
            row[f"{name}_most_moved_bytes"] = max(moved, default=0)
            gates[f"{arch} {name} collective of a tick, bytes, below one "
                  f"layer's cache shard ({layer_bytes})"] = [
                max(moved, default=0), layer_bytes - 1]
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{arch}: non-finite {name} logits")
            if name == "fp32":
                gates[f"{arch} {KVSEQ_TICKS} ticks (fp32) against one "
                      "device"] = [_range_err(got, want["fp32"]), 1e-5]
                mine = [S.shard_of(w, sp, mesh) for w, sp in zip(
                    caches(whole), caches(specs))]
                gates[f"{arch} cache shard after the ticks (fp32) against "
                      "one device's, over its range"] = [max(
                          ((a - w).abs().max() / (w.max() - w.min())).item()
                          for a, w in zip(shard, mine)), 1e-6]
                del whole, states, params, step, shard, mine
                free()
                continue
            row["launches"] = {k: c.launches for k, c in counters.items()}
            row["decode_positions"] = sorted(positions)
            for k, n in row["launches"].items():
                launches[k] += n
            per_tick = launches_per_call(cfg)[1]
            gates[f"{arch} launches a bf16 tick"] = [sum(
                abs(row["launches"][k] / KVSEQ_TICKS - per_tick.get(k, 0))
                for k in counters), 0]
            gates[f"{arch} positions a decode launch (0 = the rank's "
                  f"{KVSEQ_BUF // 2})"] = [
                0 if row["decode_positions"] == [KVSEQ_BUF // 2] else 1, 0]
            row["cache_bytes"] = sum(t.numel() * t.element_size()
                                     for t in shard)
            row["one_device_cache_bytes"] = sum(
                t.numel() * t.element_size() for t in caches(whole))
            if one:
                err = (got - want["bf16"]).abs().max().item()
                rounding = (want["bf16"] - want["fp32"]).abs().max().item()
                span = (want["bf16"].max() - want["bf16"].min()).item()
                row["bf16_rounding_error"] = rounding
                gates[f"{arch} {KVSEQ_TICKS} ticks (bf16) against one "
                      "device"] = [err, max(5e-2 * span, 2 * rounding)]
            del whole, states, params, step, shard
            free()
        del full
        free()
        row["seconds"] = time.perf_counter() - start
        res["models"][arch] = row
    ops.decode_attention = orig
    res["launches"] = launches
    res["gates"] = gates
    res["peak_gb"] = max(peak, _peak_gb(dev))
    return res



# ---------------------------------------------------------------------------
# phase 13: the dry-run
# ---------------------------------------------------------------------------

def run_dryrun(card, dev) -> dict:
    """Phase 13 (see the module docstring): one spawned process counts
    and runs the cells (``_dryrun_rank``) and writes its readings to a
    file that this process reads and gates."""
    import tempfile

    from repro_torch.launch import mesh as LM
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        LM.run_ranks(_dryrun_rank, 1, (tmp, dev.type))
        out = json.loads(Path(tmp, "dryrun.json").read_text())
    out["card"] = card
    for name, (value, limit) in out["gates"].items():
        if not value <= limit:
            raise AssertionError(f"dryrun: {name} {value:.3e} > "
                                 f"{limit:.3e}")
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = DRYRUN_BUDGET_S
    return out


def dryrun_cells():
    """Phase 13's cells: {name: (config, ShapeConfig, TrainConfig)}."""
    from repro_torch.configs.base import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.train.train_step import TrainConfig
    cfg_t, tcfg, _, _ = mesh_train_setup(None)
    full = get_arch("olmo-1b")
    return {"train": (cfg_t, ShapeConfig("train", TRAIN_LEN, TRAIN_BATCH,
                                         "train"), tcfg),
            "prefill": (full, ShapeConfig("prefill", PREFILL_LEN,
                                          PREFILL_BATCH, "prefill"),
                        TrainConfig()),
            "decode": (full, ShapeConfig("decode", DRYRUN_BUF,
                                         len(DRYRUN_CACHE_LENS), "decode"),
                       TrainConfig())}


def _dryrun_counts(out, gates, dev) -> dict:
    """Each cell counted on a fake (1, 1) mesh on fake CUDA tensors and
    fake CPU tensors (CPU only in a rehearsal without a card); the
    equality and record gates; the CUDA count's roofline and peak."""
    from repro_torch.core.provision.autotune import KERNELS
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline import analysis as RA
    devices = ("cuda", "cpu") if dev.type == "cuda" else ("cpu",)
    counted = {}
    for name, (cfg, shape, tcfg) in dryrun_cells().items():
        got = {d: DR.count_cell(cfg, shape, (1, 1), tcfg=tcfg, device=d)
               for d in devices}
        first = got[devices[0]]
        cost = first["cost"]
        gates[f"{name}: fields that differ between fake cuda and cpu"] = [
            sum(got[devices[0]]["cost"].program()[k]
                != got[d]["cost"].program()[k]
                for d in devices for k in cost.program()), 0]
        roof = RA.analyze(cost, cfg, shape, 1)
        counted[name] = {"cost": cost, "roof": roof,
                         "peak_bytes": first["args_bytes"]
                         + cost.peak_bytes}
        out["cells"][name] = {
            "count": cost.as_dict(), "count_s": {
                d: got[d]["seconds"] for d in devices},
            "args_bytes": first["args_bytes"], "temp_bytes": cost.peak_bytes,
            "roofline": {k: roof.as_dict()[k] for k in (
                "compute_s", "memory_s", "collective_s", "dominant",
                "step_time_s", "model_flops", "useful_flops_ratio")}}
    for name, kernel in (("prefill", "flash_attention"),
                         ("decode", "decode_attention")):
        recs = counted[name]["cost"].kernels
        cfg, shape, _ = dryrun_cells()[name]
        want_shape = {"b": shape.global_batch, "s": shape.seq_len,
                      "h": cfg.n_heads, "kv": cfg.n_kv_heads,
                      "d": cfg.resolved_head_dim, "dtype": "bfloat16"}
        kw = {"valid": shape.global_batch * shape.seq_len} \
            if kernel == "decode_attention" else {}
        flops, nbytes = KERNELS[kernel].cost(want_shape, **kw)
        gates[f"{name}: |records - {cfg.n_layers}|"] = [
            abs(len(recs) - cfg.n_layers), 0]
        gates[f"{name}: records not at {kernel}'s cost"] = [
            sum(r != {"name": kernel, "shape": want_shape, "flops": flops,
                      "bytes": nbytes} for r in recs), 0]
    return counted


def _dryrun_rank(rank: int, world: int, outdir: str, dev_type: str) -> None:
    """Phase 13's process: the counts (``_dryrun_counts``), then the same
    steps on a real (1, 1) mesh of one rank (nccl; gloo in a CPU
    rehearsal): each cell's measured time, the train step's measured
    peak, each prefill call's and tick's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    out, gates = {"cells": {}, "gates": {}}, {}
    out["gates"] = gates
    counted = _dryrun_counts(out, gates, dev)
    cells = dryrun_cells()
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)
    rng = np.random.default_rng(13)

    def tokens(cfg, b, s):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                               dtype=torch.int32, device=dev)

    def timed(fn, calls):
        ms = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{LM.free_port()}", rank=0,
        world_size=1, **({"device_id": torch.device("cuda", 0)}
                         if backend == "nccl" else {}))
    try:
        mesh = LM.make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        # the train step: its args, a warm-up, a step whose peak is read
        cfg, shape, tcfg = cells["train"]
        _, _, ocfg, _ = mesh_train_setup(dev)
        specs = TS.sharded_specs(cfg, mesh)
        params, opt = TS.shard_train_state(M.init_params(cfg, 0, device=dev),
                                           tcfg, *specs[1:], mesh)
        step = TS.make_sharded_train_step(cfg, tcfg, ocfg, mesh, device=dev,
                                          specs=specs)
        toks = tokens(cfg, shape.global_batch, shape.seq_len + 1)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        step(params, opt, batch)
        _sync(dev)
        _reset_peak(dev)
        ms = timed(lambda: step(params, opt, batch), DRYRUN_TIMED)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        out["cells"]["train"]["ms"] = ms
        out["cells"]["train"]["measured_peak_bytes"] = peak
        out["cells"]["train"]["predicted_peak_bytes"] = \
            counted["train"]["peak_bytes"]
        del params, opt, step
        free()
        if dev.type == "cuda":
            gates["train: |predicted - measured peak| / measured"] = [
                abs(counted["train"]["peak_bytes"] - peak) / peak,
                DRYRUN_PEAK_TOL]

        # the prefill: each call's launches
        cfg, shape, _ = cells["prefill"]
        _, pspecs, _ = TS.sharded_specs(cfg, mesh)
        params = S.distribute(M.init_params(cfg, 0, device=dev), pspecs,
                              mesh)
        free()
        pre = D.make_sharded_prefill_step(cfg, mesh, device=dev)
        batch = {"tokens": tokens(cfg, shape.global_batch, shape.seq_len)}
        per_call = []

        def call():
            before = counters["flash_attention"].launches
            pre(params, batch)
            per_call.append(counters["flash_attention"].launches - before)
        call()
        _sync(dev)
        out["cells"]["prefill"]["ms"] = timed(call, DRYRUN_TIMED)
        out["cells"]["prefill"]["launches_per_call"] = per_call
        launches["flash_attention"] += sum(per_call)

        # the tick
        cfg, shape, _ = cells["decode"]
        state = D.init_sharded_decode_state(cfg, mesh, shape.global_batch,
                                            shape.seq_len, device=dev)
        serve = D.make_sharded_serve_step(cfg, mesh, shape.seq_len,
                                          device=dev)
        clen = torch.tensor(DRYRUN_CACHE_LENS, dtype=torch.int32, device=dev)
        per_tick = []
        for i in range(DRYRUN_TICKS):
            before = counters["decode_attention"].launches
            serve(params, state, {"tokens": tokens(cfg, shape.global_batch,
                                                   1),
                                  "cache_len": clen + i})
            per_tick.append(counters["decode_attention"].launches - before)
        _sync(dev)
        out["cells"]["decode"]["launches_per_tick"] = per_tick
        launches["decode_attention"] += sum(per_tick)
        del params, state
    finally:
        dist.destroy_process_group()
    free()
    if dev.type == "cuda":
        for name, calls in (("prefill", per_call), ("decode", per_tick)):
            want = cells[name][0].n_layers
            gates[f"{name}: calls whose launches are not {want}"] = [
                sum(n != want for n in calls), 0]
    for name in ("train", "prefill"):
        cell = out["cells"][name]
        median = float(np.median(cell["ms"])) / 1e3
        cell["roofline_over_measured"] = \
            cell["roofline"]["step_time_s"] / median
        gates[f"{name}: roofline step_time_s / measured median"] = [
            cell["roofline_over_measured"], 1.0]
    out["launches"] = launches
    Path(outdir, "dryrun.json").write_text(json.dumps(out))


def run_examples(card, counters, dev) -> dict:
    """Phase 14 (see the module docstring): ``serve_batch.run`` at --full
    for EXAMPLE_ARCHS with the launch counters and the (heads, head dim)
    of every decode launch, then ``hyperparam_sweep.main`` on the card and
    on the CPU, each in a root under build/ that it deletes."""
    import shutil
    import tempfile

    import torch

    from repro_torch.examples import hyperparam_sweep as HS
    from repro_torch.examples import serve_batch as SB
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map
    t0 = time.perf_counter()
    out = {"card": card, "gates": {}, "serve_batch": {},
           "launches": dict.fromkeys(counters, 0)}

    def gate(name, value, limit):
        out["gates"][name] = [value, limit]
        if not value <= limit:
            raise AssertionError(f"examples: {name} {value:.3e} > "
                                 f"{limit:.3e}")

    seen = set()
    orig = ops.decode_attention

    def decode(q, *a, **kw):
        seen.add(tuple(q.shape[2:]))                  # (H, D)
        return orig(q, *a, **kw)
    ops.decode_attention = decode
    batch, prompt_len, max_new = 4, 8, 12             # the reference's flags
    ticks = prompt_len + max_new - 1
    try:
        for arch in EXAMPLE_ARCHS:
            cfg = SB.config(arch, full=True)
            for c in counters.values():
                c.launches = 0
            seen.clear()
            _reset_peak(dev)
            t1 = time.perf_counter()
            tokens = SB.run(arch, batch, prompt_len, max_new, full=True,
                            device=dev)
            _sync(dev)
            secs = time.perf_counter() - t1
            launches = {k: c.launches for k, c in counters.items()}
            for k, n in launches.items():
                out["launches"][k] += n
            per_tick = launches_per_call(cfg)[1].get("decode_attention", 0)
            want = {k: per_tick * ticks if k == "decode_attention" else 0
                    for k in launches}
            gate(f"{arch}: launches off the expected "
                 f"({per_tick} decode a tick x {ticks} ticks)",
                 sum(abs(launches[k] - want[k]) for k in launches)
                 if dev.type == "cuda" else 0, 0)
            if dev.type == "cuda":
                gate(f"{arch}: decode launches not at {cfg.n_heads} heads "
                     f"of {cfg.resolved_head_dim}",
                     len(seen ^ {(cfg.n_heads, cfg.resolved_head_dim)}), 0)
            ok = tuple(tokens.shape) == (batch, max_new) and bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
            gate(f"{arch}: tokens not of (B, max_new) in the vocab",
                 0 if ok else 1, 0)
            out["serve_batch"][arch] = {
                "layers": cfg.n_layers, "seconds": secs, "ticks": ticks,
                "ms_per_tick": 1e3 * secs / ticks, "launches": launches,
                "decode_heads": sorted(seen), "peak_gb": _peak_gb(dev)}
            free()
            params = M.init_params(cfg, SB.WEIGHT_SEED, device=dev)
            prompt, _ = SB.inputs(cfg, batch, prompt_len)
            fp32 = SB.run(arch, batch, prompt_len, max_new, full=True,
                          device=dev, params=params, prompt=prompt,
                          compute_dtype=torch.float32)
            gap = greedy_gap(cfg, params, prompt, fp32, dev)
            gate(f"{arch}: fp32 tokens' gap to one forward's argmax, over "
                 "the row's range", gap, EXAMPLES_GAP)
            params16 = M.cast_params(tree_map(lambda t: t, params),
                                     torch.bfloat16)
            flips = first_flips(cfg, params, params16, prompt, fp32, tokens,
                                dev)
            for f in flips:
                gate(f"{arch}: row {f['row']}'s first bf16 flip (step "
                     f"{f['step']}): fp32 top-2 margin over twice the bf16 "
                     "logit error there", f["fp32_margin"],
                     2 * f["bf16_err"])
            out["serve_batch"][arch] |= {
                "fp32_gap": gap,
                "bf16_tokens_equal_fp32": float(
                    (tokens.cpu() == fp32.cpu()).float().mean()),
                "first_flips": flips}
            del params, params16
            free()
    finally:
        ops.decode_attention = orig

    for c in counters.values():
        c.launches = 0
    sweeps = {}
    for where in (dev.type, "cpu") if dev.type == "cuda" else ("cpu",):
        root = Path(tempfile.mkdtemp(prefix="sweep-", dir=ROOT / "build"))
        t1 = time.perf_counter()
        try:
            sweeps[where] = HS.main(["--device", where,
                                     "--workdir", str(root)])
        finally:
            shutil.rmtree(root)
        sweeps[where]["seconds"] = time.perf_counter() - t1
    got, cpu = sweeps[dev.type], sweeps["cpu"]
    gate("sweep: stages not FINISHED (of 10)",
         sum(s != "FINISHED" for s in got["states"])
         + abs(len(got["states"]) - 10), 0)
    gate("sweep: |DAG edges - 16|", abs(got["edges"] - 16), 0)
    gate("sweep: broken pipeline's states unlike the CPU run's",
         0 if got["broken"] == cpu["broken"] else 1, 0)
    gate(f"sweep: jobs whose tensors were not on {dev.type}",
         sum(not d.startswith(dev.type) for d in got["devices"].values()),
         0)
    gate("sweep: kernel launches", sum(c.launches for c in
                                       counters.values()), 0)
    gate("sweep: metadata keys unlike the CPU run's",
         0 if sorted(got["best"]) == sorted(cpu["best"]) else 1, 0)
    out["sweep"] = {w: {k: v[k] for k in ("stages", "held", "states",
                                          "edges", "broken", "seconds")}
                    | {"best_accuracy": v["best"]["accuracy"],
                       "devices": sorted(set(v["devices"].values()))}
                    for w, v in sweeps.items()}
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = EXAMPLES_BUDGET_S
    return out


def greedy_gap(cfg, params, prompt, tokens, dev) -> float:
    """Greedy tokens (B, n) held against one fp32 forward over the prompt
    (B, S) and the tokens, which keeps no decode state: the largest, over
    the generated positions, of the forward's row max less its logit of
    the token chosen, over the row's range (0 where every token is the
    forward's argmax)."""
    import torch

    from repro_torch.models import model as M
    seq = torch.cat([prompt.to(dev), tokens[:, :-1].to(dev)], 1)
    ctx = M.make_ctx(cfg, seq.shape[1], "prefill",
                     compute_dtype=torch.float32, device=dev)
    with torch.no_grad():
        logits = M.forward(params, seq, cfg, ctx)[0][
            :, prompt.shape[1] - 1:].float()
    chosen = logits.gather(-1, tokens.to(dev)[..., None].long())[..., 0]
    top, low = logits.amax(-1), logits.amin(-1)
    return float(((top - chosen) / (top - low)).max())


def first_flips(cfg, params, params16, prompt, tokens32, tokens16,
                dev) -> list:
    """Where bf16 greedy tokens (B, n) first leave the fp32 ones, row by
    row: the step j of each row's first flip, the fp32 forward's top-2
    margin at that step, and the bf16 forward's largest logit error there
    against the fp32 one. Both forwards (``params`` in fp32,
    ``params16`` cast to bf16) run over the prompt and the fp32 tokens,
    which before step j are the tokens both runs chose, so at step j both
    see the prefix the flip came from. A flip is a near-tie when its
    margin is at most twice that error (phase 14's gate); a wider one
    would be a fault. Rows without a flip give nothing."""
    import torch

    from repro_torch.models import model as M
    flips = [(r, int(row.nonzero()[0])) for r, row in enumerate(
        (tokens16.cpu() != tokens32.cpu())) if bool(row.any())]
    if not flips:
        return []
    seq = torch.cat([prompt.to(dev), tokens32[:, :-1].to(dev)], 1)
    logits = []
    for tree, dtype in ((params, torch.float32), (params16, torch.bfloat16)):
        ctx = M.make_ctx(cfg, seq.shape[1], "prefill", compute_dtype=dtype,
                         device=dev)
        with torch.no_grad():
            logits.append(M.forward(tree, seq, cfg, ctx)[0][
                :, prompt.shape[1] - 1:].float().cpu())
    out = []
    for r, j in flips:
        l32, l16 = logits[0][r, j], logits[1][r, j]
        top2 = l32.topk(2).values
        out.append({"row": r, "step": j,
                    "fp32_margin": float(top2[0] - top2[1]),
                    "bf16_err": float((l16 - l32).abs().max())})
    return out


def _rank_heads(cfg, kernel: str) -> int:
    """The heads a kernel launch sees on a rank of a model axis of 2."""
    if kernel == "wkv6":
        return cfg.d_model // cfg.rwkv.head_dim // 2
    if kernel == "mamba2_ssd":
        return cfg.mamba.n_heads(cfg.d_model) // 2
    return cfg.n_heads // 2


def _leaves(tree):
    from repro_torch.train.optimizer import leaves
    return leaves(tree)


def _to(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
