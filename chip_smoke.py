#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (singa_tpu_torch), one GPU.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  Phases, none of them caught — any failure exits
non-zero before the last line is printed:

1. Card and build: the card's name and power limit, then nvcc builds
   every kernel from singa_tpu_torch/csrc (one process per source, in
   parallel); build time, each kernel's ptxas registers and spills, and
   the HMMA (tensor-core) instructions of K1-K4 by `cuobjdump -sass`
   (their bf16 bodies must have some).
2. K1 and K2 against their plain PyTorch versions on the card, at the
   bench shapes, at lm.conf's strided geometry (one head of 32 per row
   over B·H = 64 rows, S = 512, bf16, causal; timed too) and a few more
   (GQA, non-causal, every head dim, both
   dtypes, ragged edges; for K2 vocabs that are not a multiple of its
   split and an exact tie across a split boundary), each with its
   stated tolerance; kernel times on the card's clock by a CUDA-graph
   replay of direct launches (SDPA's forward and, for K2, the bare
   h.W^T product likewise), with the wrapper's host time, TFLOP/s and
   share of the bound beside them; plain times by CUDA events.
3. The scoring forward: the repo's bench stack (transformer_lm 12L,
   E=768, 12 heads of 64, V=32768, S=1024, B=8, bf16 compute) with
   random weights from a numpy seed, through
   `NeuralNet.apply(train=False)`.  The launch counts are set to 0 just
   before and read just after: K1 must run 12 times and K2 once.  Then
   the same weights at 2 layers and batch 2 on the card and on the CPU:
   each attention layer's output, K2's per-token lse, label logit and
   hit, and the loss must agree.  Then the eval step:
   `Trainer.evaluate` over 10 bench batches, as CUDA-graph replays and
   eagerly, in turns: tokens/s, a profiled step's idle share, K1 12 and
   K2 once per batch, and averages equal to the bit.
4. Serving, on the same stack with f32 weights.  4a, the bucketed
   engine: warm-up must capture one CUDA graph per (mode, bucket)
   (generate is the whole unrolled decode); replayed greedy answers must
   equal eager (`graphs=False`) ones and `generate` on the unpadded
   prompts, predict must match `forward_cached`, seeded sampling must
   give the same tokens on two engines and on an eager one; tokens/s
   replayed and eager in turns, the idle share of each, and no capture
   after warm-up.  4b, continuous batching (`ContinuousScheduler`,
   32 slots, blocks of 16, prompts up to 512, 128 new tokens at most,
   1281 pool blocks: 1.51 GB of f32 pools, which `pool_bytes` must
   match): 96 greedy requests (lengths and max_new from numpy seed 11)
   submitted before `start()` must all finish with `length`, 0 failed,
   no capture after the two graphs of warm-up; the 4 shortest and 4
   longest answers must equal `generate` (a differing token must sit at
   a top-2 logit gap below 1e-4, which is printed), and an eager engine
   must give every answer equal; 32 sampled requests must give the same
   tokens twice; the decode step with all 32 slots active and the
   prefill, replayed and eager in turns, profiles, generated tokens/s,
   latency and queue-wait percentiles and peak memory.  No kernel of
   K1-K6 runs on the serving path.
5. K3 and K4 (the flash backward) against their plain versions, at the
   bench shape and at lm.conf's strided geometry (both timed as K1, with
   SDPA's backward as the library yardstick), and at GQA, non-causal,
   every head dim on ragged S in both dtypes, and with an lse cotangent.
6. Gradients, card against CPU: one `Trainer.gradients` of the 2-layer
   stack at batch 2 on both devices from the same weights; every param
   must get a gradient on both, within a stated share of its largest
   magnitude, and the card's run must launch K1, K3 and K4 twice each
   and K2 once.
7. Training, the LM main path: `Trainer.train_step` takes Adam steps
   of the full 12-layer bench stack at B=8 on synthetic token batches,
   as CUDA-graph replays (`graphs=None` must capture on the card); each
   replay must add K1, K3, K4 12 and K2 one launch to the counts (the
   capture's recorded launches), a profiled replay must hold those
   kernels by name, and the loss must fall.  Step time, tokens/s, an
   eager step's forward / backward / update split and the profile are
   printed; with the step captured under an obs session, one more
   replay's device phases from its graph's marks must sum (forward +
   backward + update) to within 3% of its length between two CUDA
   events, with the head's within forward + backward.
   Then eager steps (`graphs=False`) against replays from one
   copied start: after 10 steps, and again after 51, params and Adam
   state must be equal under `torch.equal`; between them 3 rounds of 10
   steps each in turns (tokens/s), `train_steps(10)` with one sync, a
   profiled step each (idle share) and the peak memory of each.  Then
   checkpoints: at 2 layers, every trainer captured, `Trainer.run`
   saves after k steps, a captured `Trainer` (its graph taken over other
   params first) resumes from the snapshot and continues, and its params
   must equal an uninterrupted chunked (`scan_chunk=4`) run's bit for
   bit.
8. K5 and K6 (the LRN forward and backward) against their plain
   versions at AlexNet-CIFAR10's norm1 and norm2 shapes (B=1024, relu
   fused, bf16 and f32; timed in bf16 by a CUDA-graph replay of direct
   launches, with the wrapper's host time, the share of the bound and
   `F.local_response_norm` on relu(x) as the library yardstick), at a
   ragged shape (N=3, C=13, L=3, beta=0.5, relu off), at C=3000 (one
   pixel per block), and at the vector route's edges in both dtypes:
   C=8, C=16 with L=9, C=2056, a runtime window and beta, pixel counts
   that are not a multiple of the tile, and a view one element into its
   storage (the general route at C=64).
9. AlexNet-CIFAR10, slices 3 and 12's main path: `examples/cifar10/
   alexnet.conf` through the port's config parser at full width, its own
   batch 1024, bf16 compute, numpy-seeded weights, synthetic CIFAR-shaped
   batches: the Trainer must capture its steps (`graphs=None`; the
   mirror and dropout draw from the trainer's own generators, registered
   with the graph and seeded per step), then 20 kSGD steps through
   `Trainer.train_step` and two more through `Trainer.train_steps`, each
   replay launching K5 and K6 twice and K1-K4 never; the same 22 steps
   eagerly from the same start must leave params and momentum equal
   under `torch.equal`, and a captured forward's draws (mirrors, dropout
   masks) must equal an eager forward's after the same seeding; replayed
   and eager steps in turns (images/s) and a profile of each (busy and
   idle share); an eager step's split, peak memory; the eval step
   through `Trainer.evaluate` (K5 twice per step); then the same weights
   at batch 4 in f32 on the card and on the CPU, whose loss and every
   gradient must agree; then MAX pooling's backward on ReLU-tied inputs
   ((k, s) = (3, 2), (2, 2), (3, 3) on 32x32 and 13x13, f32 and bf16):
   the production backward and the tie-exact oracle, card equal to CPU
   under `torch.equal`.

10. `examples/transformer/lm.conf` uncut (B=8, S=512, V=4096, E=256,
   2 blocks, block 1 a kMoE of 4 experts top-2; its attention takes
   the strided flash route; bf16, Adam) with numpy-seeded weights.
   (a) One forward and every gradient on the card and on the CPU: the
   share of tokens whose top-2 expert set (and capacity drops) agree,
   each attention output, kMoE's output on the tokens routed alike,
   the loss, and every gradient of the loss over the tokens routed
   alike, within stated shares of their largest magnitudes; K1, K3, K4
   twice each, K2 never.  (b) Eager steps
   against CUDA-graph replays (`graphs=None` must capture) from one
   copied start: equal under `torch.equal` after 10 steps (counts set
   to 0 just before the replays: 2/2/2 per step, the capture's record)
   and again after 51; 3 rounds of 10 in turns, `train_steps(10)`, a
   profiled step of each (idle share; the replay's kernels by name);
   the loss over the 51 steps on 10 repeated batches must fall and
   `moe1/aux` stay finite; kMoE's forward and backward alone, profiled:
   its products against its dispatch, beside the step's busy time.
   (c) `beam_search` (4 beams) and greedy `generate`, 32 new tokens
   from two 64-token prompts in f32, card against CPU, with the first
   divergence and its top-2 gap where tokens differ.  (d) Serving in
   f32: one bucket (8, 128) x 32 replayed against eager (equal tokens,
   tokens/s in turns), and 24 continuous-batching requests over 8 slots
   replayed against eager (all served, the same answers; a MoE shares
   each expert's capacity among the rows of a call, so answers are not
   held against `generate`).
11. The serving front ends on lm.conf uncut, served in f32.  The
   port's `Trainer` takes 10 replayed Adam steps and saves step 5 to a
   workspace (npz).  (a) The CLI's `serve -model_conf
   examples/transformer/lm.conf --workspace <ws> --serve_spec
   'buckets=1x16/4x32/8x64,max_new_tokens=32,eos_id=2' --smoke 8`
   (`main(argv)` in this process), then again with cb=on: each must
   exit 0, serve step 5 and print its snapshot; wall time each.  (b) An
   `InferenceServer` on the card (cb=on, 8 slots, the static buckets,
   HTTP and the wire, ports 0): 16 greedy requests one at a time
   through `server.generate`, HTTP /generate, HTTP ndjson streaming and
   the port's `BinaryEngineHandle` unary and streamed, in two rounds,
   must all give the tokens an eager engine (`graphs=False`) gives;
   latency p50/p99 and tokens/s per front end, and the front end's
   cost per request over in process; /healthz 200 advertising the
   wire port; /metrics with `singa_wire_*`, the serve counters and the
   captures per program.  (c) Step 10 saved while 6 clients load the
   server (reload poll 50 ms): the `serve.reload` event must say
   "reloaded", no request fails, answers afterwards equal an eager
   engine over step 10's params, no capture after warm-up and every
   param's `data_ptr` unchanged; the save-to-first-answer time and the
   reload's `copy_` ms.  (d) A step-15 snapshot with verdict
   "diverged" must be refused: /healthz 503 with the stale reason,
   still serving step 10.  The serving path launches none of K1-K6
   (counts set to 0 before the server starts, read after it stops).

12. Training as users run it (`[cli]` lines): the supervised CLI on
   lm.conf with a torn save and a preemption, resume, a NaN rescue, a
   spike verdict, the feeder, AlexNet from a shard folder (captured,
   one capture, 2 + 2 K5/K6 a step) and the health tier's costs.
13. The vision steps as the reference compiles them (`[vision]` lines).
   (a) A copy of alexnet.conf with a random crop of 28 at batch 1024,
   captured: 8 steps saving every 4, and another captured trainer that
   restores step 4 and trains on, must end equal under `torch.equal`;
   its crops, mirrors and masks replay as eager forwards draw them.
   (b) A copy of examples/mnist/conv.conf with the elastic distortion
   (kernel 5, sigma 6, alpha 8, beta 15, gamma 15) every 4th step,
   batch 64: 12 replayed steps over two graphs (distorting and plain)
   equal 12 eager ones; the capture cost of each; `elastic_warp` on the
   card against the CPU.  (c) The CLI on `examples/mnist/rbm.conf
   --synthetic --steps 200` (`main(argv)` in this process) exits 0;
   with rbm1 persistent (PCD), 200
   captured CD steps (one graph per RBM) equal eager ones and recon
   falls in each phase.  (d) 12f's shard folder with a mean record
   written by the port's record writer as the copy's meanfile:
   captured, one capture, 8 + 8 K5/K6 launches over 4 steps.
14. Measuring the card as the reference measures the TPU (`[measure]`
   lines).  (a) Analytic train-step FLOPs (`utils/flops.py`) of the
   bench stack, lm.conf and AlexNet-CIFAR10 at 1024, and the MFU of
   phases 7, 9 and 10's replayed steps on the bf16 peak that
   `peak_flops` must find for the card.  (b) `Trainer.profile_phases`
   on the bench stack and on AlexNet: shares that sum to 1, one eager
   step launching K1/K2/K3/K4 12/1/12/12 (K5/K6 2/2), K1 and K2 (K5)
   under fwd, K3 and K4 (K6) under bwd, beside phases 7 and 9's
   CUDA-event splits; the next replayed step equals that of a twin
   never profiled (`torch.equal`).  (c) `python -m singa_tpu_torch.main
   -model_conf examples/transformer/lm.conf --synthetic --steps 16
   --phase_profile` exits 0 with `[device: fwd ...]` on its Time per
   step lines.  (d) `tools.convergence_run` trains conv.conf to 99% on
   the card (steps, time to 99, train time to 99).  (e) A cb=on engine
   on lm.conf in f32: `harvest_costs()` adds no capture, and `obs.perf`
   reports `singa_program_flops` and `singa_program_mfu` for the cb
   prefill and decode, the predict bucket and the train step.  (f) A
   copy of conv.conf with `debug: true`: 4 steps on the card and on the
   CPU log debug lines that name every layer and param and agree
   within 1e-4 relative.
15. The serving control plane (`[fleet]`, `[scale]`, `[procs]` lines;
   no kernel of K1-K6 may launch).  (a) The bench stack in f32, cb=on
   with 8 slots: `EngineFleet.local(..., 2)` behind the `Router`; 32
   greedy requests while a third engine is grown on another thread
   (its captures beside the siblings' replays) must each equal one
   replayed engine's answer under phase 4b's tie rule, reach both
   engines, and add no capture and no CompileWatch anomaly to a
   sibling; the grown engine answers alike, then retires, and the
   device memory must come back within MEM_SLACK; memory per engine,
   the router's host time per request, fleet against one engine in
   turns.  (b) Rollout under traffic: a workspace's first save,
   healthy, is served by exactly one engine while it is the canary
   (the sibling's params unchanged under `torch.equal`: fault C5), then
   promoted, with no refused canary (fault C6); a diverged save
   reaches one engine and is rolled back; 0 failed requests;
   canary-to-decision ms and the reloads' `copy_` ms.  (c) Three
   128-token streams on one engine, a sibling revived (no capture),
   then the streams' engine killed mid-decode: each stream completes
   exactly once, spliced, equal to the uninterrupted one under the tie
   rule; kill to the first spliced token.  (d) lm.conf in f32 under an
   `AutoScaler` (1-3 engines) and `TrafficGen`'s ramp, flash crowd and
   quiet: it must grow and shrink with 0 failed and 0 dropped requests
   and give the memory back; grow and retire ms.  (e) Two `serve
   --pinned --wire` worker processes on lm.conf adopted by
   `EngineFleet.from_hostfile(transport="auto")`: both negotiate the
   wire, one request's router and worker spans merge into one trace
   with 0 orphans (`obs.collect`), and a SIGKILL of the worker serving
   a stream is spliced onto the other exactly once; `serve --fleet 2
   --smoke 8`, a subprocess started beside the workers, must exit 0.
16. The `pipeline` subcommand on lm.conf uncut (`[pipe]` lines; a copy
   saving every 10 steps; `step.train@25:preempt,step.grad@40:spike`).
   (a) In process, twice, in turns with the same supervised run alone:
   a `PipelineController` over the supervised trainer (replayed, bf16,
   Adam, health on) and `EngineFleet.local(..., 2)` (buckets 1x16, 16
   new tokens, f32; rollout poll 50 ms, window 250 ms) on one
   workspace, one client sending requests until blessed == served; the
   trainer is held at the spike save until the rollout has decided on
   it.  0 failed requests; the preemption absorbed (65 steps trained);
   blessed == served == 60 at the end; no response below the pinned
   step, the pinned step never regresses, the spike step served by one
   engine at most (the canary) and rolled back, 0 refusals; the
   fleet's answers at step 60 equal a fresh engine's on that checkpoint
   under the tie rule; the blessed-to-served lag per blessed step (p50,
   max), training tokens/s inside the pipeline against alone, and
   K1/K3/K4 2 launches a step trained, 0 on the fleet.  (b) The CLI's
   `pipeline ... --fleet 2 --smoke 32` (`main(argv)` in this process)
   with the same faults and `--autoscale_spec`: exit 0, blessed ==
   served, 0 failed, one unblessed save, the launches of its 65 steps.
17. The elastic tier on `examples/mnist/mlp.conf` uncut (batch 1000,
   11.97M f32 params, kSGD, Elastic, moving_rate 0.9, a sync every 8
   steps after 60; `[elastic]` lines; no kernel of K1-K6).  (a) The
   CLI on `examples/mnist/mlp.conf --synthetic --steps 200`
   (`main(argv)` in this process) exits 0 (18 sync steps).  (b) 80 steps from
   numpy seed 0, replayed and eager: the params after each sync step
   (60, 68, 76), the SGD history and the center equal under
   `torch.equal`; a replayed step's ms with and without its exchange,
   and `elastic_update` alone against its byte bound (r and c read and
   written).  (c) 2 async worker groups from a cluster conf with
   `synchronous: false`, once Elastic and once RandomSync (momentum 0):
   a `ReplicaSet` of 100 steps each over the trainer's graphs; the
   replicas', the center's, the snapshots' and the graphs' tensors
   disjoint (`data_ptr`); each replica's loss falls; then the CLI with
   that cluster conf exits 0 with the center's test line.
18. Checkpoints the JAX package wrote through orbax (`[ckpt]` lines;
   `tensorstore` taken out of `sys.modules`): the committed fixtures
   `tests/torch_fixtures/orbax/` (lm_tiny.conf and conv.conf at its
   shipped width, and lm_tiny.conf under tensor_parallel: 2 written by
   2 processes, by the JAX CLI; `hashes.json` holds each leaf's sha256
   as the JAX package restores it).  (a) The native zstd
   decoder (`csrc/zstd_dec.cu`, built with the kernels) equals the plain
   one byte for byte on every frame of both (manifests, nodes, zarr
   chunks), and CRC32C agrees with the plain one and with the stored
   seals of every encoded file.  (b) `CheckpointManager(device="cuda")` restores each through
   the native decoder, every leaf's sha256 the recorded one.  (c)
   `Trainer.resume` and the CLI's `--resume` (`main(argv)` in this
   process) on copies of the conv.conf workspace take up its orbax
   step 4 and train to step 8 with finite losses, writing an orbax step
   beside it (the workspace's newest step is orbax), which the port
   lists and restores: the trainer's, leaf for leaf to the sha256 of
   the trainer's own state.  (d) An engine following the
   lm_tiny workspace serves its step, its greedy tokens equal to an
   engine's built from the sha-checked params.  (e) Restore ms of each
   fixture with the native and the plain decoder, 3 rounds in turns,
   and each decoder's MB/s over every frame on one thread.  (f) On
   copies of the conv.conf workspace: a node resealed at an unknown
   format version makes `restore` and `Trainer.resume` raise
   `OrbaxUnreadableError` naming it, and the CLI's `--resume` exit 1
   with the reason, training no step and writing nothing; a newest step
   whose zstd frame is torn is walked past to the older one.  (g) The
   bench stack's state (12 layers at full width, f32 params and Adam
   slots, 1.32 GB) saved as an orbax step into a copy of the conv.conf
   workspace and restored by a fresh manager with the native decoder:
   every leaf's sha256 the state's in memory; write and restore ms, MB/s
   and the bytes on disk.  18a also
   decodes the committed zstd corpus `tests/torch_fixtures/zstd/`
   (levels -5 to 19, checksummed and skippable frames) with both
   decoders, prints the plain one's mode counts (every mode taken), and
   holds both to `ZstdError` on its frames cut in half or with a
   reserved block type.
19. Training over several processes sharing the card (`[dist]` lines;
   gloo, staged through the host; no kernel of K1-K6).  (a)
   `examples/mnist/conv.conf` at its shipped width (batch 64) for 20
   steps through `python -m singa_tpu_torch.main` with a 2-line
   hostfile, `-procsID 0/1` and a cluster config of `data_parallel: 2`:
   per-step losses within 1e-4 relative of the single-process CLI run
   (`main(argv)` in this process) on the same global batches, final params within 1e-4 of each param's
   largest magnitude, and both ranks' params equal (their sha256, which
   the CLI checks across the ranks).  (b) The process group's start,
   the data-parallel step (eager: a gloo collective cannot be
   captured) and its gradient exchange against the single-process step
   replayed and eager.  (c) `examples/mnist/mlp.conf` at its shipped
   width (batch 1000) under `DistributedReplicaSet` of 2 processes for
   77 steps (syncs at 60, 68, 76), once Elastic and once RandomSync:
   the centers equal across the processes, and within 1e-6 of the
   in-process `ReplicaSet` on the card on the same seeds and streams;
   the all-gather's ms with host staging.  One group of 2 processes
   runs (b) and both runs of (c) in turn.
20. Tensor and sequence parallelism over processes sharing the card
   (`[tpsp]` lines; gloo, staged through the host; every step eager).
   (a) One process: `flash_chunk`, ring attention's local step, at the
   bench stack's ring chunk (B=8, H=6 and 12, Sq=Sk=512, D=64, bf16),
   causal and non-causal, forward and backward under a nonzero lse
   cotangent, against the plain versions of K1, K3 and K4; each
   launches K1, K3 and K4.  (b) The bench stack at full width and depth
   (12 layers, E=768, 12 heads of 64, V=32768, S=1024, B=8, bf16, Adam)
   under `model=2` on 2 processes, 5 steps from numpy seed 0: losses
   within 3e-4 relative of the single-process eager run on the same
   batches, both ranks' gathered params equal (sha256) and their move
   from the init within 0.5 relative of that run's; step ms, the
   collectives' ms a step (host staging and the wait for the card
   included), each rank's param and optimizer bytes against one
   process's, and K1/K2/K3/K4 launches per rank.  (c) As (b) under
   `seq=2`, ring attention, then Ulysses.  (d) The shipped
   `examples/transformer/cluster.conf` unedited (data 2 x model 2 x seq
   2) through `python -m singa_tpu_torch.main` on 8 processes, with the
   bench stack's config written as text at full width with
   `seq_parallel: "ring"`, cut to 2 layers (printed): 3 steps, the
   ranks' `agree` digests equal, losses and the checkpoint's move from
   the init held to the single-process CLI's on the same config, as
   (b); the checkpoint rank 0 writes, whole, restored by one process
   that trains on from it.  (e) `examples/transformer/lm.conf` under
   `tensor_parallel: 2` through the CLI on 2 processes, 10 steps (its
   ring layers take the strided K1/K3/K4 route under a seq axis of 1,
   kMoE stays whole): its losses against the single-process CLI's.
21-22. Pipeline and expert parallelism (`[pipe]`, `[moe]` lines).
23. The rest of the mesh (`[cdp]`, `[mixed]` lines).  (a)
   `examples/mnist/rbm.conf` uncut (rbm1 as PCD) under data=2 on 2
   processes, 40 CD steps: params within 1e-5 and every step's recon
   within 1e-6 of one process's on the same batches and global
   uniforms; then through the CLI with `-hostfile`, resumed by one
   process.  (b) The bench stack at full width and depth in 2 stages on
   pipe=2 x model=2 (4 processes), 5 steps: losses within 3e-4 of one
   process's, K1-K4 counted on each rank.  (c) Depth 2 on pipe=2 x
   seq=2; lm.conf's 2 blocks as 2 stages on pipe=2 x expert=2.  (d) The
   same on data=2 x pipe=2: moe1 in stage 2 drops what one process
   drops routing each cell's tokens alone, and no aux term reaches the
   loss or the metrics.

Every process the script starts runs under `START_PRELUDE`, which
times it: `[time] start <tag>` lines give its interpreter, torch, port
and CUDA-context times, its gloo group's start and its first train
step; `[time] group` lines a group's wall; `[time] in process` lines a
one-process CLI run that a group is held against, which runs through
`main(argv)` in the script's process.  The children share a bytecode
cache under `build/pycache`.

Every result line ends with the card's `nvidia-smi` name and power
limit.  The last lines are one JSON object listing each kernel with its
launches (K1-K4 over phase 7's training run, K5/K6 over phase 9's),
error, times and bound; the card's `nvidia-smi` name and power limit;
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense: bf16 tensor cores (main() reads the port's
# `utils.flops.peak_flops` for the card), f32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# card against CPU at 2 layers (compare_small), about 4x the gaps an
# H100 showed: attn0/attn1 0.0078/0.0156 (one bf16 ulp at their largest
# magnitude, 3.6/3.3), per-token lse 0.0072, label logit 0.035
ATTN_RTOL = 2 ** -6     # of the layer output's largest magnitude
LSE_ATOL = 0.03
LL_ATOL = 0.15
LOSS_RTOL = 1e-4

BENCH = dict(vocab_size=32768, num_layers=12, embed_dim=768, num_heads=12,
             head_dim=64, seq_len=1024, batchsize=8)
EVAL_BATCHES = 10       # phase 3's Trainer.evaluate, captured and eager


CARD = ""               # nvidia-smi's name and power limit, set by main()
# step times and splits that phases 7, 9 and 10 measured, for phase 14
MEASURED: dict = {}


def log(msg: str) -> None:
    """A line of results, with the card's name and power limit once
    main() has read them."""
    print(f"{msg} [{CARD}]" if CARD else msg, flush=True)


def trainer_log(msg: str) -> None:
    log(f"[trainer] {msg}")


# Every process the script starts runs under this prelude.  It notes, in
# a JSON file the parent reads afterwards, when the interpreter came up,
# when torch and the port were imported and the card's context made, how
# long `distributed_init` (the gloo group) took and the first train step
# of the process (`Trainer.train_step`, `train_steps` or `cd_step`, the
# card synchronised after it), then runs the command it wraps.
START_PRELUDE = """
import json, sys, time
t = {"python": time.time()}
stamp, argv = sys.argv[1], sys.argv[2:]
def note():
    with open(stamp, "w") as f:
        json.dump(t, f)
import torch
t["torch"] = time.time()
import singa_tpu_torch
t["port"] = time.time()
if torch.cuda.is_available():
    torch.cuda.init()
t["ready"] = time.time()
note()
from singa_tpu_torch.core import trainer as _trainer
from singa_tpu_torch.parallel import bootstrap as _bootstrap
_init = _bootstrap.distributed_init
def _timed_init(*a, **k):
    t0 = time.time()
    out = _init(*a, **k)
    t["group_s"] = time.time() - t0
    note()
    return out
_bootstrap.distributed_init = _timed_init
def _first(name):
    fn = getattr(_trainer.Trainer, name)
    def wrapped(self, *a, **k):
        if "first_step_s" in t or t.get("busy"):
            return fn(self, *a, **k)
        t["busy"], t0 = True, time.time()
        try:
            out = fn(self, *a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            t["busy"] = False
        t["first_step_s"] = time.time() - t0
        note()
        return out
    setattr(_trainer.Trainer, name, wrapped)
for _name in ("train_step", "train_steps", "cd_step"):
    _first(_name)
import runpy
if argv[0] == "-m":
    sys.argv = [argv[1], *argv[2:]]
    runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
elif argv[0] == "-c":
    sys.argv = ["-c", *argv[2:]]
    exec(compile(argv[1], "<string>", "exec"), {"__name__": "__main__"})
else:
    sys.argv = list(argv)
    runpy.run_path(argv[0], run_name="__main__")
"""
START_DIR = [None]      # where the start notes go (a temp dir of main())
STARTS: list = []       # (tag, seconds to ready) of every process started


def spawn(cmd, tag):
    """`cmd` (a Python command line) under `START_PRELUDE`: returns the
    command to run and a `started` callable that logs the process's
    start once it has ended."""
    assert cmd[0] == sys.executable, cmd
    base = START_DIR[0] or os.path.join(REPO, "build")
    os.makedirs(base, exist_ok=True)
    stamp = os.path.join(base, f"start_{len(STARTS)}_{os.getpid()}_"
                         f"{re.sub(r'[^\w.-]', '_', tag)}.json")
    STARTS.append((tag, None))
    slot = len(STARTS) - 1
    t0 = time.time()

    def started(rc=None) -> None:
        end = time.time()
        try:
            with open(stamp) as f:
                t = json.load(f)
            os.remove(stamp)
        except (OSError, ValueError):
            t = {}
        parts = [f"ended {end - t0:.2f} s after its start"
                 + ("" if rc is None else f" (exit {rc})")]
        if "ready" in t:
            parts.insert(0, f"interpreter {t['python'] - t0:.2f} s, torch "
                         f"imported {t['torch'] - t0:.2f} s, the port "
                         f"{t['port'] - t0:.2f} s, the card's context "
                         f"{t['ready'] - t0:.2f} s")
            STARTS[slot] = (tag, t["ready"] - t0)
        if "group_s" in t:
            parts.append(f"gloo group start {t['group_s']:.2f} s")
        if "first_step_s" in t:
            parts.append(f"first train step {t['first_step_s']:.2f} s")
        log(f"[time] start {tag}: " + "; ".join(parts))
    return [sys.executable, "-c", START_PRELUDE, stamp, *cmd[1:]], started



def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, by CUDA
    events after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Mean device time of one `fn` call on the card's own clock: CUDA
    events around replays of a CUDA graph that holds `n` calls, so no
    host time between launches is counted.  `fn` launches into
    preallocated outputs (a direct `_kernels.launch`) or allocates from
    the graph's own pool."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def host_ms(fn, n: int = 50) -> float:
    """Host time of one `fn` call (enqueue only: no synchronise inside
    the loop), the wrapper's cost on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def rate_line(name: str, res: dict, flops: float) -> str:
    """Achieved TFLOP/s and the share of the bound, from the graph-timed
    kernel time."""
    return (f"[kernels] {name}: {flops / res['ms'] / 1e9:.1f} TFLOP/s, "
            f"{res['bound_ms'] / res['ms']:.3f} of the bound "
            f"({res['bound_by']}); wrapper {res['wrapper_ms']:.4f} ms per "
            f"call on the host")


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile(tag: str, fn, wall_ms: float, top: int = 8) -> dict:
    """One traced call of `fn`: device time and events by kernel name,
    and the device's busy and idle share of `wall_ms`, an untraced call's
    time.  Returns the busy ms, the idle share and the events by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    counts: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            counts[e.name] = counts.get(e.name, 0) + 1
    busy = sum(by_name.values())
    if not by_name:
        log(f"[profile] {tag}: the profiler recorded no device time "
            f"(busy share not measured)")
        return {"busy_ms": None, "idle": None, "counts": {}, "ms": {}}
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"[profile] {tag}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"untraced wall, idle share {idle:.3f}, {len(by_name)} kernel "
        f"names, {sum(counts.values())} device events")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile] {tag}:   {t:9.3f} ms  {100 * t / busy:5.1f}%  "
            f"{counts[name]:4d}x  {name[:90]}")
    return {"busy_ms": busy, "idle": idle, "counts": counts, "ms": by_name}


def count_named(counts: dict, names) -> dict:
    """Device events of a profile whose kernel name holds each of
    `names` as a whole word."""
    return {n: sum(c for k, c in counts.items()
                   if re.search(rf"\b{n}\b", k)) for n in names}


def _short(symbols) -> dict:
    """Mangled kernel names -> `name<template args>`, by c++filt (part of
    the binutils that nvcc builds with)."""
    symbols = list(symbols)
    names = subprocess.run(["c++filt"], input="\n".join(symbols),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {sym: name.replace("(anonymous namespace)::", "")
            .split("(")[0].replace("void ", "")
            for sym, name in zip(symbols, names)}


def ptxas_usage(text: str) -> list:
    """(kernel, 'registers; stack and spill bytes') for each entry that
    `nvcc -Xptxas -v` reports in `text`."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            used = line.split(":", 1)[-1].strip()
            rows.append((fn, f"{used}; {spill}"))
            fn = None
    names = _short(f for f, _ in rows)
    return [(names[f], u) for f, u in rows]


def sass_hmma(name: str) -> dict:
    """HMMA (tensor-core) instructions per kernel in the built library of
    kernel `name`, read by the toolkit's `cuobjdump -sass` (beside the
    nvcc that built it)."""
    from singa_tpu_torch.ops import _kernels
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_kernels._target(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    names = _short(counts)
    return {names[f]: n for f, n in counts.items()}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_flash(b, s, h, hkv, d, dtype, causal, dev, seed, timed=False):
    from singa_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h * d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, hkv * d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv * d), generator=g, device=dev).to(dtype)
    out, lse = A.flash_attention_packed_lse(q, k, v, h, causal, hkv)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_plain(q, k, v, h, causal, hkv)
    err_o = (out.float() - ref_out.float()).abs().max().item()
    err_l = (lse - ref_lse).abs().max().item()
    # both sides compute in f32 (in bf16 both round P before P.V) and
    # differ only in summation order; a bf16 output may then round one
    # ulp apart (|O| < 4: ulp <= 2^-6)
    tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tol_l = 1e-3
    tag = (f"K1 flash_fwd b={b} s={s} h={h} hkv={hkv} d={d} "
           f"{str(dtype).split('.')[-1]} causal={causal}")
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_o <= tol_o and err_l <= tol_l, (tag, err_o, err_l)
    res = {"max_abs_err": err_o}
    if timed:
        from singa_tpu_torch.ops import _kernels
        o_buf, l_buf = torch.empty_like(out), torch.empty_like(lse)
        res["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o_buf.data_ptr(), l_buf.data_ptr(), b, s, s, h, hkv, d,
            int(causal), A.fold_constant(d, dtype), A._DTYPE_CODE[dtype]))
        res["wrapper_ms"] = host_ms(lambda: A.flash_attention_packed_lse(
            q, k, v, h, causal, hkv))
        res["plain_ms"] = time_ms(lambda: A.flash_forward_plain(
            q, k, v, h, causal, hkv), 5, 1)
        qs = q.view(b, s, h, d).transpose(1, 2)
        ks = k.view(b, s, hkv, d).transpose(1, 2)
        vs = v.view(b, s, hkv, d).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = (graph_ms(lambda: sdpa(qs, ks, vs,
                                                   is_causal=causal))
                             if h == hkv else None)
        pairs = s * (s + 1) // 2 if causal else s * s
        esz = q.element_size()
        nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * esz \
            + b * s * h * 4
        flops = 4.0 * d * pairs * b * h
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    log(f"[kernels] {tag}: max|dO| {err_o:.3g} (tol {tol_o}), "
        f"max|dlse| {err_l:.3g} (tol {tol_l})"
        + (f", kernel {res['ms']:.4f} ms (graph), plain "
           f"{res['plain_ms']:.4f} ms, sdpa {res['library_ms']} ms "
           f"(graph), bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
           if timed else ""))
    if timed:
        log(rate_line("K1 flash_fwd", res, flops))
        if res["library_ms"]:
            log(f"[kernels] K1 flash_fwd: {res['ms'] / res['library_ms']:.2f}"
                f"x SDPA's forward in this run")
    return res


def head_inputs(n, e, v, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, e), generator=g, device=dev).to(dtype)
    w = (torch.randn((v, e), generator=g, device=dev)
         / math.sqrt(e)).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    return h, w, labels


def check_head(n, e, v, dtype, dev, seed, timed=False, inputs=None):
    from singa_tpu_torch.ops import head_loss as H
    h, w, labels = inputs or head_inputs(n, e, v, dtype, dev, seed)
    lse, ll, hit = H.head_stats(h, w, labels)
    torch.cuda.synchronize()
    r_lse, r_ll, r_hit = H.head_stats_plain(h, w, labels)
    err = max((lse - r_lse).abs().max().item(),
              (ll - r_ll).abs().max().item())
    agree = (hit == r_hit).float().mean().item()
    # f32 sums of E exact products (both dtypes) in another order: ~1e-6
    # relative; a hit may flip only where the two best logits tie that
    # closely
    tag = f"K2 head_fwd n={n} e={e} v={v} {str(dtype).split('.')[-1]}"
    assert torch.isfinite(lse).all() and torch.isfinite(ll).all()
    assert torch.allclose(lse, r_lse, rtol=1e-4, atol=1e-4), tag
    assert torch.allclose(ll, r_ll, rtol=1e-4, atol=1e-4), tag
    assert agree >= 0.999, (tag, agree)
    res = {"max_abs_err": err, "hit": hit}
    if timed:
        from singa_tpu_torch.ops import _kernels
        lbl = labels.to(torch.int32)
        outs = torch.empty((3, n), dtype=torch.float32, device=dev)
        ranges, per = H.v_splits(v)
        ws = torch.empty((ranges, n, 4), dtype=torch.float32, device=dev)
        res["ms"] = graph_ms(lambda: _kernels.launch(
            "head_fwd", h.data_ptr(), w.data_ptr(), lbl.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            ws.data_ptr(), n, e, v, per, H._DTYPE_CODE[dtype]))
        res["wrapper_ms"] = host_ms(lambda: H.head_stats(h, w, labels))
        res["plain_ms"] = time_ms(lambda: H.head_stats_plain(h, w, labels),
                                  3, 1)
        res["library_ms"] = None
        esz = h.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            (n * e + v * e) * esz + n * 8 + 3 * n * 4, 2.0 * n * v * e,
            dtype)
        # a reference, not K2's library column: the bare product with an
        # f32 output (cuBLAS), without the statistics, writing n*v logits
        res["mm_ms"] = graph_ms(lambda: torch.mm(
            h, w.T, out_dtype=torch.float32), n=5)
    log(f"[kernels] {tag}: max err {err:.3g} (rtol/atol 1e-4), hit "
        f"agreement {agree:.5f} (>= 0.999)"
        + (f", kernel {res['ms']:.4f} ms (graph), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
           f"({res['bound_by']})" if timed else ""))
    if timed:
        log(rate_line("K2 head_fwd", res, 2.0 * n * v * e))
        log(f"[kernels] K2 head_fwd: reference, the bare product torch.mm("
            f"h, w.T, out_dtype=float32) at the same shape "
            f"{res['mm_ms']:.4f} ms (graph; {n * v * 4 / 2 ** 30:.2f} GiB "
            f"of logits, no statistics): K2 is "
            f"{res['ms'] / res['mm_ms']:.2f}x it")
    return res


def check_head_tie(n, e, v, dtype, dev, seed):
    """Columns b - 1 and b, the last of K2's first vocab range and the
    first of its second, hold equal rows of W whose logit (exactly 8)
    beats every other: the hit must name the lower column, exactly."""
    from singa_tpu_torch.ops import head_loss as H
    h, w, labels = head_inputs(n, e, v, dtype, dev, seed)
    _, per = H.v_splits(v)
    b = per * H.MMA_BV
    h[:, 0] = 8.0
    w[:, 0] = 0.0
    w[b - 1] = w[b] = 0.0
    w[b - 1, 0] = w[b, 0] = 1.0
    labels[labels == b - 1] = 0
    labels[: n // 2] = b - 1
    labels[n // 2: 3 * n // 4] = b
    hit = check_head(n, e, v, dtype, dev, seed,
                     inputs=(h, w, labels))["hit"]
    want = (torch.arange(n, device=dev) < n // 2).float()
    assert torch.equal(hit, want), ("tie across a split", dtype)
    log(f"[kernels] K2 head_fwd n={n} e={e} v={v} "
        f"{str(dtype).split('.')[-1]}: exact tie across the split at "
        f"column {b}: every hit names column {b - 1}")


def phase_kernels(dev):
    bf16, f32 = torch.bfloat16, torch.float32
    k1 = check_flash(8, 1024, 12, 12, 64, bf16, True, dev, 1, timed=True)
    # lm.conf's strided route: one head of 32 per row over B·H = 64 rows
    check_flash(64, 512, 1, 1, 32, bf16, True, dev, 100, timed=True)
    check_flash(8, 1024, 12, 4, 64, bf16, True, dev, 2)      # GQA
    check_flash(8, 1024, 12, 12, 64, bf16, False, dev, 3)    # non-causal
    check_flash(8, 1024, 12, 12, 32, bf16, True, dev, 4)     # D=32
    check_flash(2, 1024, 8, 8, 96, bf16, True, dev, 8)       # D=96, padded
    # every tile width, padded widths, and D past 128 in 128-wide chunks
    for i, d in enumerate((8, 16, 24, 32, 40, 64, 96, 128, 136, 264)):
        check_flash(2, 200, 4, 2, d, f32, True, dev, 10 + i)  # ragged S
        check_flash(1, 256, 2, 1, d, bf16, False, dev, 30 + i)
        # the tensor-core body on ragged S, GQA, causal and not
        check_flash(2, 200, 4, 2, d, bf16, True, dev, 50 + i)
        check_flash(2, 200, 4, 2, d, bf16, False, dev, 70 + i)
    k2 = check_head(8192, 768, 32768, bf16, dev, 5, timed=True)
    check_head(2048, 768, 32768, f32, dev, 6)
    check_head(100, 96, 1000, f32, dev, 7)                    # ragged
    # the tensor-core body: ragged N and V; vocabs that are not a
    # multiple of the split (40 and 250 tiles of 128 in 8 ranges)
    check_head(100, 96, 1000, bf16, dev, 8)
    check_head(1000, 256, 5000, bf16, dev, 9)
    check_head(1024, 768, 32000, bf16, dev, 10)
    for dtype in (bf16, f32):
        check_head_tie(256, 768, 32768, dtype, dev, 11)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 5: K3 and K4 against their plain versions


def check_flash_bwd(b, s, h, hkv, d, dtype, causal, dev, seed,
                    with_dlse=False, timed=False):
    from singa_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q = randn(b, s, h * d).to(dtype)
    k = randn(b, s, hkv * d).to(dtype)
    v = randn(b, s, hkv * d).to(dtype)
    dout = randn(b, s, h * d).to(dtype)
    with torch.no_grad():
        out, lse = A.flash_attention_packed_lse(q, k, v, h, causal, hkv)
    delta = (dout.float() * out.float()).reshape(b, s, h, d).sum(-1)
    if with_dlse:
        delta = delta - randn(b, s, h)
    args = (q, k, v, dout, lse, delta, h, causal, hkv)
    dq = A.flash_dq(*args)
    dk, dv = A.flash_dkv(*args)
    torch.cuda.synchronize()
    ref = (A.flash_dq_plain(*args), *A.flash_dkv_plain(*args))
    # both sides sum f32 products in another order (in bf16 both round P
    # and dS at the same places before K3's and K4's products): f32
    # outputs agree to
    # ~1e-6 of their magnitude (tolerance 1e-4); a bf16 output may round
    # one ulp (2^-8 relative) apart at its largest magnitude (tol 2^-7)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    tag = (f"b={b} s={s} h={h} hkv={hkv} d={d} "
           f"{str(dtype).split('.')[-1]} causal={causal}"
           + (" dlse" if with_dlse else ""))
    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got.float()).all(), (tag, name)
        assert err <= rtol * top, (tag, name, err, top)
        errs.append((name, err, top))
    res = {"dq": {"max_abs_err": errs[0][1]},
           "dkv": {"max_abs_err": max(errs[1][1], errs[2][1])}}
    if timed:
        from singa_tpu_torch.ops import _kernels
        ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
        sizes = (b, s, s, h, hkv, d, int(causal), A.fold_constant(d, dtype),
                 A._DTYPE_CODE[dtype])
        dq_buf, dk_buf, dv_buf = (torch.empty_like(t) for t in (dq, dk, dv))
        res["dq"]["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_dq", *ptrs, dq_buf.data_ptr(), *sizes))
        res["dkv"]["ms"] = graph_ms(lambda: _kernels.launch(
            "flash_dkv", *ptrs, dk_buf.data_ptr(), dv_buf.data_ptr(),
            *sizes))
        res["dq"]["wrapper_ms"] = host_ms(lambda: A.flash_dq(*args))
        res["dkv"]["wrapper_ms"] = host_ms(lambda: A.flash_dkv(*args))
        res["dq"]["plain_ms"] = time_ms(lambda: A.flash_dq_plain(*args), 3, 1)
        res["dkv"]["plain_ms"] = time_ms(lambda: A.flash_dkv_plain(*args),
                                         3, 1)
        lib = (sdpa_backward_ms(q, k, v, dout, h, causal) if h == hkv
               else None)
        res["dq"]["library_ms"] = res["dkv"]["library_ms"] = lib
        pairs = s * (s + 1) // 2 if causal else s * s
        esz = q.element_size()
        stats = 2 * b * s * h * 4                       # lse, delta
        res["dq"]["bound_ms"], res["dq"]["bound_by"] = bound(
            (3 * b * s * h * d + 2 * b * s * hkv * d) * esz + stats,
            6.0 * d * pairs * b * h, dtype)
        res["dkv"]["bound_ms"], res["dkv"]["bound_by"] = bound(
            (2 * b * s * h * d + 4 * b * s * hkv * d) * esz + stats,
            8.0 * d * pairs * b * h, dtype)
    log(f"[kernels] K3/K4 {tag}: "
        + ", ".join(f"max|d{n[1:]}| {e:.3g} (tol {rtol * t:.3g})"
                    for n, e, t in errs)
        + ("".join(f"; {n} kernel {r['ms']:.4f} ms (graph), plain "
                   f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                   f"({r['bound_by']})" for n, r in res.items())
           + f"; SDPA backward {res['dq']['library_ms']} ms"
           if timed else ""))
    if timed:
        log(rate_line("K3 flash_dq", res["dq"], 6.0 * d * pairs * b * h))
        log(rate_line("K4 flash_dkv", res["dkv"], 8.0 * d * pairs * b * h))
        if lib:
            log(f"[kernels] K4 flash_dkv: {res['dkv']['ms'] / lib:.2f}x "
                f"SDPA's whole backward in this run; K3 + K4 "
                f"{(res['dq']['ms'] + res['dkv']['ms']) / lib:.2f}x")
    return res


def sdpa_backward_ms(q, k, v, dout, num_heads, causal):
    """PyTorch's SDPA backward at the same shape: its forward-and-backward
    less its forward (both with autograd recording), each on the card's
    clock by a CUDA-graph replay — the yardstick for K3 and K4 as a
    pair."""
    b, s, hd = q.shape
    d = hd // num_heads

    def heads(x):      # SDPA's own (B, H, S, D) layout, contiguous
        return x.view(b, s, num_heads, d).transpose(1, 2).contiguous()
    qs, ks, vs = (heads(x).requires_grad_() for x in (q, k, v))
    dos = heads(dout)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        return sdpa(qs, ks, vs, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qs, ks, vs), dos)
    return graph_ms(fwd_bwd, 10) - graph_ms(fwd, 10)


def phase_flash_bwd(dev):
    bf16, f32 = torch.bfloat16, torch.float32
    bench = check_flash_bwd(8, 1024, 12, 12, 64, bf16, True, dev, 41,
                            timed=True)
    # lm.conf's strided route: one head of 32 per row over B·H = 64 rows
    check_flash_bwd(64, 512, 1, 1, 32, bf16, True, dev, 101, timed=True)
    check_flash_bwd(8, 1024, 12, 4, 64, bf16, True, dev, 42)    # GQA
    check_flash_bwd(8, 1024, 12, 12, 64, bf16, False, dev, 43)  # non-causal
    check_flash_bwd(2, 1024, 12, 12, 64, bf16, True, dev, 44,
                    with_dlse=True)
    # every tile width, padded widths, D past 64 in 64-wide chunks, ragged
    for i, d in enumerate((8, 24, 64, 96, 128, 136, 264)):
        check_flash_bwd(2, 200, 4, 2, d, f32, True, dev, 50 + i)
        check_flash_bwd(2, 200, 4, 2, d, f32, False, dev, 60 + i,
                        with_dlse=True)
        check_flash_bwd(1, 256, 2, 1, d, bf16, True, dev, 70 + i)
        # the tensor-core body of K4 on ragged S, GQA, causal and not
        check_flash_bwd(2, 200, 4, 2, d, bf16, True, dev, 80 + i)
        check_flash_bwd(2, 200, 4, 2, d, bf16, False, dev, 90 + i,
                        with_dlse=True)
    return bench


# ---------------------------------------------------------------------------
# phase 3: the scoring forward


def build(cfg_kw, seq_len):
    from singa_tpu_torch import build_net, transformer_lm
    cfg = transformer_lm(**{**cfg_kw, "seq_len": seq_len})
    return build_net(cfg, "kTest", {"data": {"input": (seq_len,),
                                             "target": (seq_len,)}})


def phase_forward(dev, arrays):
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    net = build(BENCH, s)
    params = params_from_numpy(net, arrays, device=dev)
    batch = next(synthetic_token_batches(b, s, vocab, seed=0))

    def forward(p=params, n=net, x=batch):
        with torch.no_grad():
            return n.apply(p, x, train=False, compute_dtype=torch.bfloat16)

    _kernels.reset_launches()
    _, metrics, _ = forward()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    loss, prec = float(metrics["loss"]), float(metrics["precision"])
    log(f"[forward] {BENCH['num_layers']}L b={b} s={s}: launches "
        f"{launches}, loss {loss:.5f} (ln V = {math.log(vocab):.5f}), "
        f"precision {prec:.6f}")
    assert math.isfinite(loss) and abs(loss - math.log(vocab)) < 1.0, loss
    assert 0.0 <= prec <= 1.0
    ms = time_ms(forward, 5, 1)
    log(f"[forward] {ms:.3f} ms per forward, {b * s / ms * 1e3:.1f} "
        f"tokens/s")
    profile("forward", forward, ms, top=10)

    # the same weights at 2 layers, batch 2 (N = 2048, still K2-legal):
    # card (kernels) against CPU (plain versions), both bf16 compute, on
    # what the kernels decide: each attention layer's output and K2's
    # per-token lse, label logit and hit on the final hidden state.
    compare_small(dev, arrays)
    phase_eval(dev, arrays)
    return launches


def bench_trainer(dev, graphs, test_steps=0):
    """A Trainer of the bench stack in bf16 (Adam), its steps captured
    (graphs=True, or None: the default, which must capture on the card)
    or eager (False)."""
    from singa_tpu_torch import Trainer, transformer_lm
    cfg = transformer_lm(**BENCH, precision="bfloat16")
    cfg.test_steps = test_steps
    tr = Trainer(cfg, SHAPES, device=dev, graphs=graphs, log_fn=trainer_log)
    assert tr.graphs is (graphs is not False), (tr.graphs, graphs)
    return tr


def phase_eval(dev, arrays):
    """The eval step, `Trainer.evaluate` over EVAL_BATCHES bench batches:
    CUDA-graph replays against eager steps, in turns; the averages must
    be equal to the bit, each step must launch K1 12 times and K2 once."""
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    data = synthetic_token_batches(b, s, vocab, seed=5)
    batches = [next(data) for _ in range(EVAL_BATCHES)]
    runs = {}
    for mode, graphs in (("eager", False), ("graph", True)):
        tr = bench_trainer(dev, graphs, test_steps=EVAL_BATCHES)
        params = params_from_numpy(tr.train_net, arrays, device=dev)

        def evaluate(tr=tr, params=params):
            return tr.evaluate(params, iter(batches), EVAL_BATCHES,
                               tr.test_step)
        _kernels.reset_launches()
        avg = evaluate()        # the graph's warm-up and capture, then replays
        torch.cuda.synchronize()
        assert dict(_kernels.LAUNCHES) == {
            **{k: 0 for k in PER_STEP}, "flash_fwd": 12 * EVAL_BATCHES,
            "head_fwd": EVAL_BATCHES}, (mode, _kernels.LAUNCHES)
        runs[mode] = dict(tr=tr, params=params, evaluate=evaluate, avg=avg,
                          ms=[])
    for r in range(3):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            run = runs[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = run["evaluate"]()
            run["ms"].append((time.perf_counter() - t0) * 1e3 / EVAL_BATCHES)
            assert again == run["avg"], (mode, again, run["avg"])
    for mode, run in runs.items():
        ms = min(run["ms"])
        log(f"[eval] {mode}: Trainer.evaluate over {EVAL_BATCHES} batches "
            f"(b={b}, s={s}; one fetch at the end), per batch "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-3 (turns), "
            + ", ".join(f"{b * s / t * 1e3:.1f}" for t in run["ms"])
            + " tokens/s; loss {loss:.7f}, precision {precision:.7f}"
            .format(**run["avg"]))
        tr, params = run["tr"], run["params"]
        prof = profile(f"eval_step ({mode})",
                       lambda: tr.test_step(params, batches[0]), ms)
        run["idle"] = prof["idle"]
    same = runs["eager"]["avg"] == runs["graph"]["avg"]
    log(f"[eval] captured and eager averages equal to the bit: {same}; "
        f"idle share eager {runs['eager']['idle']}, graph "
        f"{runs['graph']['idle']}")
    assert same, (runs["eager"]["avg"], runs["graph"]["avg"])


def compare_small(dev, arrays):
    from singa_tpu_torch import params_from_numpy, synthetic_token_batches
    from singa_tpu_torch.ops import head_loss
    bf16, s, vocab = torch.bfloat16, BENCH["seq_len"], BENCH["vocab_size"]
    small = {**BENCH, "num_layers": 2, "batchsize": 2}
    net = build(small, s)
    arr = {k: arrays[k] for k in net.param_specs}
    batch = next(synthetic_token_batches(2, s, vocab, seed=1))
    head = net.layers["loss"]
    w_key = net.param_aliases.get(head.w_key, head.w_key)
    res = {}
    for d in (dev, "cpu"):
        p = params_from_numpy(net, arr, device=d)
        with torch.no_grad():
            _, m, out = net.apply(p, batch, train=False, compute_dtype=bf16)
            h = out["ln_f"].reshape(-1, small["embed_dim"]).contiguous()
            w = p[w_key].to(bf16).contiguous()
            lse, ll, hit = head_loss.head_stats(h, w, out["labels"].reshape(-1))
        res[d] = {"loss": float(m["loss"]), "lse": lse.cpu(), "ll": ll.cpu(),
                  "hit": hit.cpu(), "h": h.float().cpu(), "w": w.float().cpu(),
                  **{n: out[n].float().cpu() for n in ("attn0", "attn1")}}
    card_, cpu = res[dev], res["cpu"]
    # The two sides round bf16 activations after differently ordered f32
    # sums, so they drift apart by a few bf16 ulps over two layers; a
    # wrong kernel moves these outputs by their own magnitude (~1).
    for n in ("attn0", "attn1"):
        gap = (card_[n] - cpu[n]).abs().max().item()
        top = cpu[n].abs().max().item()
        log(f"[forward] 2L b=2 {n}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g} (tol {ATTN_RTOL} * max|cpu|)")
        assert torch.isfinite(card_[n]).all() and gap <= ATTN_RTOL * top, n
    for n, tol in (("lse", LSE_ATOL), ("ll", LL_ATOL)):
        gap = (card_[n] - cpu[n]).abs().max().item()
        log(f"[forward] 2L b=2 K2 per-token {n}: max|card - cpu| {gap:.3g} "
            f"(tol {tol})")
        assert gap <= tol, n
    # a hit may differ only where the CPU's two best logits are closer
    # than the label logits are apart at most
    tie = 2 * (card_["ll"] - cpu["ll"]).abs().max().item()
    flips = (card_["hit"] != cpu["hit"]).nonzero()[:, 0]
    for i in flips.tolist():
        top2 = (cpu["h"][i] @ cpu["w"].T).topk(2).values
        assert (top2[0] - top2[1]).item() <= tie, ("hit flip", i)
    lc, lp = card_["loss"], cpu["loss"]
    log(f"[forward] 2L b=2: card loss {lc:.7f}, cpu loss {lp:.7f} (rtol "
        f"{LOSS_RTOL}); {len(flips)} hit(s) differ, all at near-ties "
        f"(top-2 gap <= {tie:.3g})")
    assert abs(lc - lp) <= LOSS_RTOL * abs(lp), (lc, lp)


# ---------------------------------------------------------------------------
# phase 4: serving, 4a the bucket engine replayed, 4b continuous batching

NEAR_TIE = 1e-4         # a greedy token may differ only below this top-2 gap


def in_turns(runs: dict, rounds: int = 3) -> dict:
    """Host ms of each run's callable, `rounds` times in turns (the order
    flips every round); each callable ends in a fetch to the host."""
    ms = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_serve(dev, arrays):
    """4a: one CUDA graph per (mode, bucket), captured at warm-up; replays
    against eager calls and the unpadded `generate`."""
    from singa_tpu_torch import (InferenceEngine, ServeSpec, generate,
                                 params_from_numpy)
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    from singa_tpu_torch.ops import _kernels
    vocab = BENCH["vocab_size"]
    net = build(BENCH, BENCH["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, vocab, n))
               for n in (128, 100, 77, 64, 50, 33, 17, 5)]
    bucket, max_new = (8, 128), 32
    greedy_spec = ServeSpec(buckets=(bucket,), max_new_tokens=max_new)
    sampled_spec = ServeSpec(buckets=(bucket,), max_new_tokens=max_new,
                             temperature=0.8, top_k=50, top_p=0.9, seed=3)
    _kernels.reset_launches()
    engines = {}
    for name, spec, graphs in (("graph", greedy_spec, None),
                               ("eager", greedy_spec, False),
                               ("sampled graph", sampled_spec, None),
                               ("sampled graph 2", sampled_spec, None),
                               ("sampled eager", sampled_spec, False)):
        eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                              graphs=graphs)
        t0 = time.perf_counter()
        n = eng.warmup(("generate", "predict"))
        assert eng.graphs is (graphs is None) and \
            n == (2 if eng.graphs else 0), (name, eng.graphs, n)
        if eng.graphs:
            log(f"[serve] {name}: warm-up captured {n} graphs "
                      f"(generate and predict at bucket {bucket}) in "
                      f"{time.perf_counter() - t0:.3f} s")
        engines[name] = eng
    captured = {k: e.stats.compiles for k, e in engines.items()}

    out = {k: np.stack(engines[k].answer("generate", prompts))
           for k in ("graph", "eager")}
    assert out["graph"].shape == (8, max_new) and \
        ((out["graph"] >= 0) & (out["graph"] < vocab)).all()
    assert np.array_equal(out["graph"], out["eager"]), \
        "replayed greedy tokens != eager"
    for row, prompt in zip(out["graph"], prompts):
        with torch.no_grad():
            want = generate(net, params, np.array([prompt]), max_new)
        assert np.array_equal(row, want[0].cpu().numpy()), \
            ("padded greedy != unpadded generate", len(prompt))
    ms = in_turns({k: (lambda e=engines[k]: e.answer("generate", prompts))
                   for k in ("eager", "graph")})
    for k in ("eager", "graph"):
        log(f"[serve] 4a greedy bucket {bucket} x {max_new} new "
                  f"tokens, {k}: "
                  + ", ".join(f"{t:.3f}" for t in ms[k])
                  + " ms in rounds 1-3 (turns), "
                  + ", ".join(f"{8 * max_new / t * 1e3:.1f}" for t in ms[k])
                  + " tokens/s (prefill included)")
    log("[serve] 4a replayed greedy tokens equal eager ones and "
              "unpadded generate's")
    for k in ("graph", "eager"):
        prof = profile(f"bucket generate ({k})",
                       lambda e=engines[k]: e.answer("generate", prompts),
                       min(ms[k]))
        log(f"[serve] 4a bucket generate ({k}): idle share "
                  f"{prof['idle']}")

    # predict: next-token log-probs of the padded bucket against
    # forward_cached on each unpadded prompt (f32: rtol/atol 1e-3 covers
    # the reordered sums of shifted RoPE positions and batch shapes), and
    # the replay against the eager call
    lp = {k: engines[k].answer("predict", prompts) for k in ("graph",
                                                            "eager")}
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(lp["graph"], lp["eager"]))
    assert gap <= 1e-5, gap
    for row, prompt in zip(lp["graph"], prompts):
        with torch.no_grad():
            cache = init_cache(net, 1, len(prompt) + 1, torch.float32, dev)
            logits, _ = forward_cached(
                net, params, torch.tensor([prompt], device=dev), cache, 0)
            want = torch.log_softmax(logits[0, -1], dim=-1).cpu().numpy()
        np.testing.assert_allclose(row, want, rtol=1e-3, atol=1e-3)
    log(f"[serve] 4a predict bucket matches forward_cached per "
              f"prompt; replay against eager max|diff| {gap:.3g}")

    sampled = {k: np.stack(engines[k].answer("generate", prompts))
               for k in ("sampled graph", "sampled graph 2",
                         "sampled eager")}
    s0 = sampled["sampled graph"]
    assert s0.shape == (8, max_new) and ((s0 >= 0) & (s0 < vocab)).all()
    assert np.array_equal(s0, sampled["sampled graph 2"]), \
        "seeded sampling differs between two engines"
    assert np.array_equal(s0, sampled["sampled eager"]), \
        "seeded sampling: replay != eager"
    again = np.stack(engines["sampled eager"].answer("generate", prompts))
    assert not np.array_equal(again, s0), "the next call drew the same"
    log(f"[serve] 4a top-k/top-p sampled bucket: {len(set(s0.ravel()))} "
              f"distinct tokens, reproducible from its seed, replay equal "
              f"to eager")
    assert {k: e.stats.compiles for k, e in engines.items()} == captured, \
        "captured after warm-up"
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log(f"[serve] 4a no capture after warm-up (compiles "
              f"{captured}); no kernel of K1-K6 on the serving path")


CB_SPEC = dict(cb="on", cb_slots=32, cb_block_len=16, cb_prompt_cap=512,
               max_new_tokens=128, queue_capacity=128,
               request_timeout_s=600.0)
CB_REQUESTS = 96


def cb_traffic(vocab: int):
    """96 greedy requests: prompt lengths uniform in 16-512 and max_new
    in 16-128, from numpy seed 11."""
    rng = np.random.default_rng(11)
    plens = rng.integers(16, 513, CB_REQUESTS)
    max_news = rng.integers(16, 129, CB_REQUESTS)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in plens]
    return prompts, [int(m) for m in max_news]


def serve_cb(net, params, dev, prompts, max_news, graphs, **spec_kw):
    """Submit every request before `start()` (the order of admission is
    then fixed), serve them all, and return the engine, the results and
    the wall time from `start()` to the last answer."""
    from singa_tpu_torch import InferenceEngine, ServeSpec
    from singa_tpu_torch.serve import ContinuousScheduler
    spec = ServeSpec(**{**CB_SPEC, **spec_kw})
    eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                          graphs=graphs)
    n = eng.warmup(("generate",))
    assert n == (2 if graphs is None else 0), n
    sched = ContinuousScheduler(eng, log_fn=log)
    tickets = [sched.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
    t0 = time.perf_counter()
    sched.start()
    try:
        outs = [t.wait(600.0) for t in tickets]
    finally:
        sched.stop()
    wall = time.perf_counter() - t0
    for out, m in zip(outs, max_news):
        assert out["finish"] == "length" and len(out["tokens"]) == m, \
            (out["finish"], len(out["tokens"]), m)
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and snap["completed"] == len(prompts), snap
    assert eng.stats.compiles == n, "captured after warm-up"
    return eng, sched, outs, wall


def first_divergence(net, params, dev, prompt, got, want) -> tuple:
    """(index, top-2 logit gap of the contiguous reference there) of the
    first token where a paged answer leaves `generate`'s."""
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want[:i])
    with torch.no_grad():
        cache = init_cache(net, 1, len(seq), torch.float32, dev)
        logits, _ = forward_cached(net, params,
                                   torch.tensor([seq], device=dev), cache, 0)
    top2 = logits[0, -1].topk(2).values
    return i, float(top2[0] - top2[1])


def phase_cb(dev, arrays):
    """4b: continuous batching over the paged KV cache, prefill and decode
    step as CUDA graphs, against eager programs and `generate`."""
    from singa_tpu_torch import generate, params_from_numpy
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.serve.kvcache import pool_bytes
    vocab = BENCH["vocab_size"]
    net = build(BENCH, BENCH["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    prompts, max_news = cb_traffic(vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _kernels.reset_launches()

    eng, sched, outs, wall = serve_cb(net, params, dev, prompts, max_news,
                                      None)
    spec = eng.spec
    assert (spec.cb_prefill_len, spec.cb_blocks_per_slot,
            spec.cb_pool_blocks) == (512, 40, 1281)
    nbytes = pool_bytes(net, spec.cb_pool_blocks, spec.cb_block_len)
    held = sum(t.numel() * t.element_size()
               for e in eng.cb_pools.values() for t in e.values())
    assert nbytes == held, (nbytes, held)
    ntok = sum(len(o["tokens"]) for o in outs)
    snap = eng.stats.snapshot()
    qw99 = eng.stats.split_quantile("queue_wait", 0.99)
    log(f"[cb] 4b graph: {len(outs)} of {CB_REQUESTS} greedy requests "
              f"served (finish length), 0 failed, {snap['cb_steps']} "
              f"scheduler steps, {ntok} tokens in {wall:.3f} s = "
              f"{ntok / wall:.1f} generated tokens/s; slot occupancy "
              f"{snap['cb_slot_occupancy']}, block utilization "
              f"{snap['cb_block_utilization']}")
    log(f"[cb] 4b graph: request latency p50/p95/p99 "
              f"{snap['p50_latency_ms']}/{snap['p95_latency_ms']}/"
              f"{snap['p99_latency_ms']} ms, queue wait p50/p95/p99 "
              f"{snap['p50_queue_wait_ms']}/{snap['p95_queue_wait_ms']}/"
              f"{qw99 * 1e3:.3f} ms, service p50/p95 "
              f"{snap['p50_service_ms']}/{snap['p95_service_ms']} ms")
    log(f"[cb] 4b pools {nbytes} bytes (pool_bytes = the tensors "
              f"held), {spec.cb_pool_blocks} blocks of {spec.cb_block_len}; "
              f"peak memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
              f"above the phase's start")

    by_len = sorted(range(CB_REQUESTS), key=lambda i: len(prompts[i]))
    for i in by_len[:4] + by_len[-4:]:
        with torch.no_grad():
            want = generate(net, params, prompts[i][None],
                            max_news[i])[0].tolist()
        got = outs[i]["tokens"]
        if got != want:
            k, gap = first_divergence(net, params, dev, prompts[i], got,
                                      want)
            log(f"[cb] request {i} (plen {len(prompts[i])}) leaves "
                      f"generate at token {k}, where the contiguous "
                      f"reference's top-2 logit gap is {gap:.3g}")
            assert gap <= NEAR_TIE, (i, k, gap)
    log("[cb] 4b the 4 shortest and 4 longest prompts' answers "
              "checked against generate on the unpadded prompt")

    eager, esched, eouts, ewall = serve_cb(net, params, dev, prompts,
                                           max_news, False)
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(outs, eouts))
    log(f"[cb] 4b eager: the same traffic in {ewall:.3f} s = "
              f"{ntok / ewall:.1f} generated tokens/s; {same} of "
              f"{CB_REQUESTS} answers equal the replayed ones")
    assert same == CB_REQUESTS

    # the decode step with every slot active and the prefill, replayed
    # and eager in turns
    s, t = spec.cb_slots, spec.cb_blocks_per_slot
    tables = (1 + np.arange(s * t, dtype=np.int32)).reshape(s, t)
    ntoks = np.full((s,), 320, np.int32)
    toks = np.random.default_rng(12).integers(0, vocab, s).astype(np.int32)
    row = tables[0, :spec.cb_prefill_len // spec.cb_block_len]
    ptoks = prompts[by_len[-1]][None, :spec.cb_prefill_len].copy()
    ptoks = np.pad(ptoks, ((0, 0), (0, spec.cb_prefill_len - ptoks.shape[1])))
    plen = len(prompts[by_len[-1]])

    def decode_steps(e, n=20):
        for _ in range(n):
            e.run_cb_decode(e.params, e.cb_pools, toks, ntoks, tables)

    def prefill(e):
        e.run_cb_prefill(e.params, e.cb_pools, ptoks, plen, row)
    dec = in_turns({"eager": lambda: decode_steps(eager),
                    "graph": lambda: decode_steps(eng)})
    pre = in_turns({"eager": lambda: prefill(eager),
                    "graph": lambda: prefill(eng)})
    for k in ("eager", "graph"):
        log(f"[cb] 4b decode step, {s} slots active at position 320, "
                  f"{k}: " + ", ".join(f"{m / 20:.3f}" for m in dec[k])
                  + " ms per step (3 rounds of 20 in turns, tokens "
                  "fetched each step); prefill at P=512: "
                  + ", ".join(f"{m:.3f}" for m in pre[k]) + " ms")
    for k, e in (("graph", eng), ("eager", eager)):
        prof = profile(f"cb decode step ({k})",
                       lambda e=e: decode_steps(e, 1), min(dec[k]) / 20,
                       top=10)
        log(f"[cb] 4b decode step ({k}): idle share {prof['idle']}")
    profile("cb prefill (graph)", lambda: prefill(eng), min(pre["graph"]))
    # a graph reads the params it was captured over: others must raise
    other = {k: v.clone() for k, v in eng.params.items()}
    try:
        eng.run_cb_decode(other, eng.cb_pools, toks, ntoks, tables)
    except ValueError as e:
        log(f"[cb] 4b a replay over other params raises: {e}")
    else:
        raise AssertionError("the decode graph replayed over other params")
    del other
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    assert eng.stats.compiles == 2 and eager.stats.compiles == 0
    del eng, sched, eager, esched
    torch.cuda.empty_cache()

    sampled = []
    for _ in range(2):
        e, sch, souts, swall = serve_cb(
            net, params, dev, prompts[:32], max_news[:32], None,
            temperature=0.8, top_k=50, top_p=0.9, seed=3)
        sampled.append([o["tokens"] for o in souts])
        del e, sch
        torch.cuda.empty_cache()
    assert sampled[0] == sampled[1], "seeded cb sampling differs"
    log(f"[cb] 4b sampled traffic (32 requests, temperature 0.8, "
              f"top_k 50, top_p 0.9, seed 3): two runs equal, "
              f"{len({t for r in sampled[0] for t in r})} distinct tokens")


# ---------------------------------------------------------------------------
# phase 6: gradients, card against CPU

# of each gradient's largest magnitude on the CPU, about 4x the worst gap
# an H100 showed (0.0126, attn1/wk): bf16 activations are rounded after
# differently ordered f32 sums on the two sides
GRAD_RTOL = 0.05
SHAPES = {"data": {"input": (BENCH["seq_len"],),
                   "target": (BENCH["seq_len"],)}}
PER_STEP = {"flash_fwd": 12, "flash_dq": 12, "flash_dkv": 12, "head_fwd": 1,
            "lrn_fwd": 0, "lrn_bwd": 0}


def small_cfg(**kw):
    from singa_tpu_torch import transformer_lm
    return transformer_lm(**{**BENCH, "num_layers": 2, "batchsize": 2,
                             "precision": "bfloat16", **kw})


def start(trainer, arrays, dev):
    from singa_tpu_torch import params_from_numpy
    net = trainer.train_net
    params = params_from_numpy(net, {k: arrays[k] for k in net.param_specs},
                               device=dev)
    return params, trainer.updater.init(params)


def phase_grads(dev, arrays):
    from singa_tpu_torch import Trainer, synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    batch = next(synthetic_token_batches(2, BENCH["seq_len"],
                                         BENCH["vocab_size"], seed=1))
    res = {}
    for d in (dev, "cpu"):
        tr = Trainer(small_cfg(), SHAPES, device=d, log_fn=trainer_log)
        params, _ = start(tr, arrays, d)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        metrics, grads = tr.gradients(params, batch)
        if d != "cpu":
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
        missing = sorted(k for k, g in grads.items() if g is None)
        log(f"[grads] 2L b=2 on {d}: loss {float(metrics['loss']):.7f}, "
            f"{len(grads)} params, none without a gradient: {not missing}"
            f" ({time.perf_counter() - t0:.1f} s)")
        assert not missing, (d, missing)
        res[d] = {k: g.float().cpu() for k, g in grads.items()}
    log(f"[grads] card launches {launches}")
    # two attention layers and the head
    assert launches == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2,
                        "head_fwd": 1, "lrn_fwd": 0, "lrn_bwd": 0}, launches
    worst = 0.0
    for name in sorted(res["cpu"]):
        want, got = res["cpu"][name], res[dev][name]
        top = want.abs().max().item()
        gap = (got - want).abs().max().item()
        worst = max(worst, gap / top)
        log(f"[grads]   {name}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {gap / top:.3g} (tol {GRAD_RTOL})")
        assert torch.isfinite(got).all() and gap <= GRAD_RTOL * top, name
    log(f"[grads] worst ratio {worst:.3g}")


# ---------------------------------------------------------------------------
# phase 7: training the bench stack, then checkpoints

TRAIN_STEPS = 20
EXACT_STEPS = 10        # eager against replay, from one copied start
ROUNDS, ROUND_STEPS = 3, 10
# what a profiled replay of the train step must hold, by kernel name
PROFILED_PER_STEP = {"flash_fwd_mma_kernel": 12, "flash_dq_mma_kernel": 12,
                     "flash_dkv_mma_kernel": 12, "head_fwd_mma_kernel": 1}
# the mean loss of the last 5 steps must sit this far (nats) below the
# first step's
LOSS_MARGIN = 0.1


def phase_train(dev, arrays):
    from singa_tpu_torch import obs
    # the step is captured under an obs session: its graph then records
    # the device marks that `check_device_phases` reads
    with obs.session():
        return train_bench(dev, arrays)


def train_bench(dev, arrays):
    from singa_tpu_torch import synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.ops.head_loss import (head_stats, logits_f32,
                                               xent_backward)
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    tr = bench_trainer(dev, None)
    params, opt = start(tr, arrays, dev)
    data = synthetic_token_batches(b, s, vocab, seed=0)
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for step, batch in enumerate(batches):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = tr.train_step(params, opt, batch, step)
        losses.append(float(m["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        assert per == PER_STEP, (step, per)
        assert math.isfinite(losses[-1]), losses
    launches = dict(_kernels.LAUNCHES)
    graphs = tr._train_graph._graphs
    captured = [g.launches for g in graphs.values()]
    assert captured == [{k: v for k, v in PER_STEP.items() if v}], captured
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tail = sum(losses[-5:]) / 5
    ms = sum(step_ms[2:]) / len(step_ms[2:])
    log(f"[train] {BENCH['num_layers']}L b={b} s={s} Adam, CUDA-graph "
        f"replays: {TRAIN_STEPS} steps, launches {launches} (the capture "
        f"recorded {captured[0]} per replay); loss first {losses[0]:.5f}, "
        f"mean of last 5 {tail:.5f} (must be < first - {LOSS_MARGIN}); "
        f"losses " + " ".join(f"{x:.4f}" for x in losses))
    assert tail < losses[0] - LOSS_MARGIN, losses
    log(f"[train] step {ms:.3f} ms (mean of steps 2..{TRAIN_STEPS - 1}, "
        f"host clock, synchronised; step 0 with warm-up and capture "
        f"{step_ms[0]:.1f}, step 1 {step_ms[1]:.1f} ms), "
        f"{b * s / ms * 1e3:.1f} tokens/s; peak device memory "
        f"{peak_gib:.2f} GiB")

    # the step's split on the card's clock (CUDA events between the
    # phases of an eager step, the second of two: the first on this
    # stream pays its first-call setup): forward with autograd
    # recording, backward, update; then the head's backward alone
    batch = batches[-1]
    names = sorted(params)
    for step in (TRAIN_STEPS, TRAIN_STEPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params.values():
            p.requires_grad_(True)
        ev[0].record()
        loss, _, _ = tr.train_net.apply(params, batch, train=True,
                                        compute_dtype=torch.bfloat16)
        ev[1].record()
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        ev[2].record()
        for p in params.values():
            p.requires_grad_(False)
        tr.updater.update(step, dict(zip(names, grads)), params, opt,
                          tr.multipliers)
        ev[3].record()
        torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    g = torch.Generator(device=dev).manual_seed(9)
    h = torch.randn((b * s, BENCH["embed_dim"]), generator=g,
                    device=dev).to(torch.bfloat16)
    w = params["embed/embedding"].to(torch.bfloat16)
    labels = torch.randint(0, vocab, (b * s,), generator=g, device=dev)
    lse = head_stats(h, w, labels)[0]
    coef = torch.tensor(1.0 / (b * s), device=dev)
    head_ms = time_ms(lambda: xent_backward(h, w, labels, lse, coef, 4096),
                      3, 1)
    # the head backward's f32 logits for one chunk: the bf16 product
    # with an f32 output (what the port takes) against upcast operands
    hc = h[:4096]
    out_ms = time_ms(lambda: logits_f32(hc, w), 5, 1)
    up_ms = time_ms(lambda: hc.float() @ w.float().T, 5, 1)
    log(f"[train] head backward logits per 4096-token chunk: bf16 product "
        f"with f32 output {out_ms:.3f} ms, f32 upcast product {up_ms:.3f} "
        f"ms")
    log(f"[train] split of an eager step (CUDA events): forward "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, update (foreach) "
        f"{upd_ms:.3f} ms; the head's backward alone {head_ms:.3f} ms")
    MEASURED["bench"] = {"ms": ms, "split": (fwd_ms, bwd_ms, upd_ms)}
    # the kernels inside one replay, by name
    prof = profile("train_step (replay)", lambda: tr.train_step(
        params, opt, batch, TRAIN_STEPS + 2), ms, top=16)
    check_replay_profile(prof, PROFILED_PER_STEP)
    check_device_phases(tr)
    return launches


# the replayed step's device phases must sum to its event-timed length
# within this share
PHASE_SUM_RTOL = 0.03


def check_device_phases(tr) -> None:
    """One more replay of the captured train step, between two CUDA
    events: its device phases, read from the marks its graph records
    (`TimerInfo.device_phases`), must sum (forward + backward + update)
    to within PHASE_SUM_RTOL of its length between the events, and the
    LM head's forward and backward must lie within forward +
    backward."""
    from singa_tpu_torch.core.trainer import DEVICE_PHASES
    graph = tr._train_graph
    torch.cuda.synchronize()
    graph.read_marks()          # an earlier replay's, left unread
    before = tr.timer.device_phases() or {"samples": 0}
    captured, = graph._graphs.values()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    captured.graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    graph._unread = captured
    graph.read_marks()
    got = tr.timer.device_phases()
    assert got is not None and got["samples"] == before["samples"] + 1, \
        (before, got, graph.marks_error)
    ms = {k: (got[k] - before.get(k, 0.0)) * 1e3 for k in DEVICE_PHASES
          if k in got}
    replay_ms = ev[0].elapsed_time(ev[1])
    total = ms["step.forward"] + ms["step.backward"] + ms["step.update"]
    log(f"[train] device phases of one replay (its graph's marks): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; forward + backward + update {total:.3f} ms against the "
        f"replay's {replay_ms:.3f} ms between events "
        f"({100 * (total / replay_ms - 1):+.2f}%, within "
        f"{100 * PHASE_SUM_RTOL:.0f}%)")
    assert abs(total - replay_ms) <= PHASE_SUM_RTOL * replay_ms, \
        (ms, replay_ms)
    assert ms["step.head"] <= ms["step.forward"] + ms["step.backward"], ms


def check_replay_profile(prof, want) -> None:
    """The kernels that the profiler saw inside one replay, counted by
    name, must be the launches the capture recorded; where it saw no
    device time, the Python count against the capture's delta (checked
    by the caller) stands alone."""
    if not prof["counts"]:
        log("[train] the profiler saw no kernels inside the replay: the "
            "launch counts rest on the capture's recorded delta")
        return
    got = count_named(prof["counts"], want)
    log(f"[train] kernels in one profiled replay, by name: {got}")
    assert got == want, (got, want)


def lm_state_gaps(a, b) -> dict:
    """Tensor name -> max |a - b| for every param and optimizer slot of
    two (params, opt_state) pairs that differ."""
    (pa, oa), (pb, ob) = a, b
    pairs = [(f"params/{n}", pa[n], pb[n]) for n in pa]
    pairs += [(f"{sl}/{n}", oa[sl][n], ob[sl][n]) for sl in oa
              for n in oa[sl]]
    return {n: (x.float() - y.float()).abs().max().item()
            for n, x, y in pairs if not torch.equal(x, y)}


def phase_graphs(dev, arrays):
    """Eager steps against CUDA-graph replays of the bench stack: from one
    copied start, EXACT_STEPS steps each must leave params and Adam state
    equal under torch.equal; then ROUNDS rounds of ROUND_STEPS steps in
    turns (tokens/s, per-step sync as run(scan_chunk=0)); train_steps
    with one sync at the end; a profiled step of each; peak memory; and
    the two must still be equal."""
    from singa_tpu_torch import synthetic_token_batches
    from singa_tpu_torch.ops import _kernels
    b, s, vocab = BENCH["batchsize"], BENCH["seq_len"], BENCH["vocab_size"]
    data = synthetic_token_batches(b, s, vocab, seed=3)
    batches = [next(data) for _ in range(EXACT_STEPS
                                         + ROUNDS * ROUND_STEPS)]
    runs = {}
    for mode, graphs in (("eager", False), ("graph", True)):
        tr = bench_trainer(dev, graphs)
        params, opt = start(tr, arrays, dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        for i in range(EXACT_STEPS):
            before = dict(_kernels.LAUNCHES)
            params, opt, _ = tr.train_step(params, opt, batches[i], i)
            per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
            assert per == PER_STEP, (mode, i, per)
        torch.cuda.synchronize()
        runs[mode] = dict(
            tr=tr, state=(params, opt), ms=[], step=EXACT_STEPS,
            peak=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            held=(torch.cuda.memory_allocated() - base) / 2 ** 30)
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[graphs] {EXACT_STEPS} eager steps and {EXACT_STEPS} replays "
        f"from one copied start: params and Adam state equal under "
        f"torch.equal: {not gaps}")
    for name, gap in sorted(gaps.items(), key=lambda kv: -kv[1]):
        log(f"[graphs]   {name}: max|graph - eager| {gap:.3g}")
    assert not gaps, f"{len(gaps)} tensors differ"

    def steps(mode, n):
        run = runs[mode]
        params, opt = run["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            k = run["step"]
            params, opt, m = run["tr"].train_step(
                params, opt, batches[k % len(batches)], k)
            float(m["loss"])        # one fetch a step, as run() drains
            run["step"] += 1
        run["state"] = (params, opt)
        return (time.perf_counter() - t0) * 1e3 / n

    for r in range(ROUNDS):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            runs[mode]["ms"].append(steps(mode, ROUND_STEPS))
    for mode, run in runs.items():
        params, opt = run["state"]
        stacked = {"data": {f: torch.from_numpy(np.stack(
            [bt["data"][f] for bt in batches[:ROUND_STEPS]])).to(dev)
            for f in ("input", "target")}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ms = run["tr"].train_steps(params, opt, stacked,
                                                run["step"], ROUND_STEPS,
                                                stacked=True)
        ms["loss"].cpu()            # the one sync
        run["scan_ms"] = (time.perf_counter() - t0) * 1e3 / ROUND_STEPS
        run["step"] += ROUND_STEPS
        run["state"] = (params, opt)
        wall = min(run["ms"])
        prof = profile(f"train_step ({mode})", lambda: steps(mode, 1), wall,
                       top=6)
        run["busy"], run["idle"] = prof["busy_ms"], prof["idle"]
        if mode == "graph":
            check_replay_profile(prof, PROFILED_PER_STEP)
    for mode, run in runs.items():
        log(f"[graphs] {mode}: step "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-{ROUNDS} of {ROUND_STEPS} (turns, host "
            f"clock, one fetch a step), "
            + ", ".join(f"{b * s / t * 1e3:.1f}" for t in run["ms"])
            + f" tokens/s; train_steps({ROUND_STEPS}) with one sync "
            f"{run['scan_ms']:.3f} ms a step, "
            f"{b * s / run['scan_ms'] * 1e3:.1f} tokens/s; profiled step "
            f"busy {run['busy']} ms, idle share {run['idle']}; peak "
            f"{run['peak']:.2f} GiB above the {EXACT_STEPS} steps' start, "
            f"{run['held']:.2f} GiB still allocated after them")
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[graphs] after {runs['graph']['step']} steps each: equal under "
        f"torch.equal: {not gaps}")
    assert runs["eager"]["step"] == runs["graph"]["step"]
    assert not gaps, sorted(gaps.items(), key=lambda kv: -kv[1])[:8]


def phase_resume(dev, arrays):
    """k steps with checkpoint_frequency k, resume into a fresh, captured
    Trainer and continue: bit-for-bit the params and state of an
    uninterrupted run (the kernels use no atomics; cuBLAS is
    deterministic on one stream).  Every trainer replays CUDA graphs; the
    uninterrupted one runs in chunks (scan_chunk), and the resumed one
    was captured over other params first, which resume's are copied
    into."""
    import shutil
    import tempfile
    from singa_tpu_torch import Trainer, synthetic_token_batches
    k, total, bsz = 3, 6, 2

    def trainer(steps):
        cfg = small_cfg(batchsize=bsz)
        cfg.train_steps, cfg.checkpoint_frequency = steps, k
        tr = Trainer(cfg, SHAPES, device=dev, log_fn=trainer_log)
        assert tr.graphs
        return tr

    def data(skip=0):
        it = synthetic_token_batches(bsz, BENCH["seq_len"],
                                     BENCH["vocab_size"], seed=2)
        for _ in range(skip):
            next(it)
        return it

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ws = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                          dir=os.path.join(REPO, "build"))
    try:
        whole = trainer(total)
        pa, oa, _ = whole.run(*start(whole, arrays, dev), data(),
                              scan_chunk=4)
        first = trainer(k)
        first.run(*start(first, arrays, dev), data(), workspace=ws)
        again = trainer(total)
        p0, o0 = start(again, arrays, dev)
        again.train_step(p0, o0, next(data(total)), 0)     # captures
        pc, oc, at = again.resume(p0, o0, ws)
        assert at == k, at
        pc, oc, _ = again.run(pc, oc, data(k), start_step=k)
        assert pc is p0 and oc is o0, "resumed tensors were not copied in"
    finally:
        shutil.rmtree(ws)
    same_p = all(torch.equal(pa[n], pc[n]) for n in pa)
    same_o = all(torch.equal(oa[sl][n], oc[sl][n]) for sl in oa
                 for n in oa[sl])
    log(f"[resume] 2L b={bsz}, CUDA-graph replays: {k} steps, snapshot, a "
        f"captured Trainer resumes at step {at} (copied into its graph's "
        f"params) and runs to {total}: params equal an uninterrupted "
        f"chunked run bit for bit: {same_p}; optimizer state: {same_o}")
    assert same_p and same_o


# ---------------------------------------------------------------------------
# phase 8: K5 and K6 against their plain versions

ALEX_SHAPES = {"norm1": (1024, 32, 32, 64), "norm2": (1024, 16, 16, 192)}


def _ulp_bf16(top: float) -> float:
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def lrn_library_ms(a, g, local_size, alpha, beta, knorm):
    """`F.local_response_norm` on the NCHW view of NHWC `a` (relu(x) when
    the kernels fuse the ReLU): its forward, and its forward-and-backward
    less its forward (autograd recording in both) — the yardstick for K5
    and for K6."""
    lrn_f = torch.nn.functional.local_response_norm
    an = a.permute(0, 3, 1, 2).detach().requires_grad_()
    gn = g.permute(0, 3, 1, 2)

    def fwd():
        return lrn_f(an, local_size, alpha, beta, knorm)

    def fwd_bwd():
        torch.autograd.grad(fwd(), an, gn)
    f = time_ms(fwd, 10)
    return f, time_ms(fwd_bwd, 10) - f


def lrn_route(x, c: int) -> str:
    """The route the LRN kernels' C entries take (csrc/lrn_common.cuh):
    8-channel groups on 16 bytes go the vector route."""
    return ("vector" if c % 8 == 0 and x.data_ptr() % 16 == 0
            else "general")


def check_lrn(shape, dtype, local_size, alpha, beta, relu, dev, seed,
              scale=1.0, timed=False, offset=0):
    """K5 and K6 against their plain versions on x of `shape`; `offset`
    elements before x in its storage move its start off 16 bytes."""
    from singa_tpu_torch.ops import lrn as L
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape)
    x = (scale * torch.randn(n + offset, generator=gen, device=dev)
         ).to(dtype)[offset:].view(shape)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    args = (local_size, alpha, beta, 1.0, relu)
    y, dx = L.lrn_fwd(x, *args), L.lrn_bwd(x, g, *args)
    torch.cuda.synchronize()
    ref_y, ref_dx = L.lrn_fwd_plain(x, *args), L.lrn_bwd_plain(x, g, *args)
    route = lrn_route(x, shape[-1])
    tag = (f"{tuple(shape)} {str(dtype).split('.')[-1]} L={local_size} "
           f"alpha={alpha} beta={beta} relu={relu} {route} route")
    errs = {}
    for name, got, want in (("lrn_fwd", y, ref_y), ("lrn_bwd", dx, ref_dx)):
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        # f32: the same f32 steps, another sqrt/pow: 1e-5 of the largest
        # |value|; bf16: the same f32 values rounded, one ulp apart at most
        tol = 1e-5 * top if dtype == torch.float32 else _ulp_bf16(top)
        assert torch.isfinite(got.float()).all(), (tag, name)
        assert err <= tol, (tag, name, err, tol)
        errs[name] = {"max_abs_err": err}
        log(f"[lrn] {name} {tag}: max err {err:.3g} (tol {tol:.3g}, "
            f"max|value| {top:.3g})")
    if timed:
        from singa_tpu_torch.ops import _kernels
        esz, c = x.element_size(), shape[-1]
        npix = n // c
        a = torch.relu(x) if relu else x
        lib_f, lib_b = lrn_library_ms(a, g, local_size, alpha, beta, 1.0)
        y_buf, dx_buf = torch.empty_like(x), torch.empty_like(x)
        code = L._DTYPE_CODE[dtype]
        for name, launch, fn, plain, nbytes, ops, lib in (
                ("lrn_fwd", lambda: _kernels.launch(
                    "lrn_fwd", x.data_ptr(), y_buf.data_ptr(), npix, c,
                    *args[:4], int(relu), code),
                 lambda: L.lrn_fwd(x, *args),
                 lambda: L.lrn_fwd_plain(x, *args), 2 * n * esz,
                 (local_size + 7) * n, lib_f),
                ("lrn_bwd", lambda: _kernels.launch(
                    "lrn_bwd", x.data_ptr(), g.data_ptr(), dx_buf.data_ptr(),
                    npix, c, *args[:4], int(relu), code),
                 lambda: L.lrn_bwd(x, g, *args),
                 lambda: L.lrn_bwd_plain(x, g, *args), 3 * n * esz,
                 (2 * local_size + 13) * n, lib_b)):
            r = errs[name]
            r["ms"] = graph_ms(launch)
            r["events_ms"] = time_ms(fn, 20)
            r["wrapper_ms"] = host_ms(fn)
            r["plain_ms"] = time_ms(plain, 5, 1)
            r["library_ms"] = lib
            # f32 arithmetic outside the tensor cores
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops, torch.float32)
            log(f"[lrn] {name} {tag}: kernel {r['ms']:.4f} ms (graph), "
                f"{r['events_ms']:.4f} ms (CUDA events around the wrapper), "
                f"plain {r['plain_ms']:.4f} ms, F.local_response_norm"
                f"{' on relu(x)' if relu else ''} {lib:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            log(f"[kernels] {'K5' if name == 'lrn_fwd' else 'K6'} {name} "
                f"{tuple(shape)}: {nbytes / r['ms'] / 1e9:.3f} TB/s, "
                f"{r['bound_ms'] / r['ms']:.3f} of the bound "
                f"({r['bound_by']}); wrapper {r['wrapper_ms']:.4f} ms per "
                f"call on the host; F.local_response_norm is "
                f"{lib / r['ms']:.2f}x the kernel in this run")
    return errs


def phase_lrn(dev):
    """Returns each kernel's record at norm1 (the larger shape)."""
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    for name, shape in ALEX_SHAPES.items():
        # inputs ~30: the window sum moves n = 1 + (alpha/L)·s visibly
        timed[name] = check_lrn(shape, bf16, 5, 1e-4, 0.75, True, dev, 80,
                                scale=30.0, timed=True)
        check_lrn(shape, f32, 5, 1e-4, 0.75, True, dev, 81, scale=30.0)
    for dtype in (f32, bf16):
        check_lrn((3, 7, 5, 13), dtype, 3, 1.0, 0.5, False, dev, 82)
        # C > 2048: one pixel per block on both routes
        check_lrn((2, 3, 3, 3000), dtype, 5, 1.0, 0.75, True, dev, 83)
        # the vector route's edges: one thread per pixel (C=8); the
        # widest unrolled window (L=9) on two threads a pixel; past 2048
        # channels (C=2056, runtime loops); a runtime beta and window
        check_lrn((4, 5, 5, 8), dtype, 5, 1.0, 0.75, True, dev, 84)
        check_lrn((4, 5, 5, 16), dtype, 9, 1.0, 0.75, False, dev, 85)
        check_lrn((2, 3, 3, 2056), dtype, 7, 1.0, 0.75, True, dev, 86)
        check_lrn((5, 4, 4, 24), dtype, 11, 1.0, 0.5, True, dev, 87)
        # pixel counts that are not a multiple of the tile (32 pixels at
        # C=64, 10 at C=192), over more tiles than the grid has blocks
        check_lrn((1000, 7, 7, 64), dtype, 5, 1e-4, 0.75, True, dev, 88,
                  scale=30.0)
        check_lrn((999, 5, 5, 192), dtype, 7, 1.0, 0.75, False, dev, 89)
        # a view one element into its storage: off 16 bytes, so the
        # general route runs at a vector route's C
        check_lrn((8, 6, 6, 64), dtype, 5, 1.0, 0.75, True, dev, 90,
                  offset=1)
    return timed["norm1"]


# ---------------------------------------------------------------------------
# phase 9: AlexNet-CIFAR10, the slice's main path

ALEX_CONF = os.path.join(REPO, "examples", "cifar10", "alexnet.conf")
RGB_SHAPES = {"data": {"pixel": (3, 32, 32), "label": ()}}
ALEX_STEPS = 20
ALEX_BATCH = 1024   # alexnet.conf's own batchsize
ALEX_PER_STEP = {"flash_fwd": 0, "head_fwd": 0, "flash_dq": 0,
                 "flash_dkv": 0, "lrn_fwd": 2, "lrn_bwd": 2}
# card against CPU at batch 4, f32, train=False: of each gradient's
# largest magnitude on the CPU, about 5x the worst gap an H100 showed
# (conv1/weight 0.0035: cuDNN and the CPU sum the first layers' small,
# cancelling gradients in another order)
ALEX_GRAD_RTOL = 0.02
ALEX_LOSS_RTOL = 1e-5
# the mean loss of the last 5 steps must sit this far (nats) below the
# first step's
ALEX_MARGIN = 0.1


ALEX_ROUNDS, ALEX_ROUND_STEPS = 3, 10    # eager against replayed, in turns


def alexnet_trainer(dev, precision, test_steps=0, logs=None, graphs=None):
    from singa_tpu_torch import Trainer, load_model_config
    cfg = load_model_config(ALEX_CONF)
    cfg.precision = precision
    cfg.test_steps = test_steps
    return Trainer(cfg, RGB_SHAPES, device=dev, graphs=graphs,
                   log_fn=(logs if logs is not None else []).append)


def clone_state(params, opt):
    return ({k: v.clone() for k, v in params.items()},
            {s: {k: v.clone() for k, v in d.items()} for s, d in opt.items()})


def alexnet_draws(tr, batch, steps=(3, 4)):
    """The train forward's draws (the RGB crops and mirrors, drop6's and
    drop7's masks) replayed against eager: a CUDA graph of the forward
    over the trainer's own generators, replayed after seeding them for
    a step, must give the outputs an eager forward seeded alike gives,
    under torch.equal; another step must draw otherwise."""
    from singa_tpu_torch.core.step_graph import StepGraph
    net = tr.train_net
    names = [net.topo[i] for i in sorted(tr._gens)]
    params = tr._state["params"]

    def forward(state, b):
        with torch.no_grad():
            _, _, out = net.apply(state["params"], b, train=True,
                                  compute_dtype=tr.compute_dtype,
                                  rng=tr.seed, generators=tr._gens)
        return {n: out[n] for n in names}
    graph = StepGraph("alexnet_draws", torch.cuda.graph_pool_handle(),
                      generators=tuple(tr._gens.values()))
    graph.capture(forward, {"params": params}, batch)
    got = {}
    for step in steps:
        tr._seed_layers(step)
        rep = {k: v.clone() for k, v in
               graph(forward, {"params": params}, batch).items()}
        tr._seed_layers(step)
        eag = forward({"params": params}, batch)
        got[step] = rep
        same = {n: torch.equal(rep[n], eag[n]) for n in names}
        log(f"[alexnet] step {step}: replayed draws equal eager ones "
            f"under torch.equal: {same}")
        assert all(same.values()), same
    a, b = steps
    assert not any(torch.equal(got[a][n], got[b][n]) for n in names)


def phase_alexnet(dev):
    from singa_tpu_torch import (numpy_params, params_from_numpy,
                                 synthetic_image_batches)
    from singa_tpu_torch.ops import _kernels
    logs = []
    tr = alexnet_trainer(dev, "bfloat16", test_steps=1, logs=logs)
    # dropout and the RGB crop and mirror draw from the trainer's own
    # generators, registered with the graphs: graphs=None captures
    drawing = [tr.train_net.topo[i] for i in sorted(tr._gens)]
    log(f"[alexnet] graphs=None: graphs {tr.graphs}; generators of "
        f"{drawing}")
    assert tr.graphs is True and drawing == ["rgb", "drop6", "drop7"], \
        (tr.graphs, drawing, logs)
    b = tr.train_net.layers["data"].batchsize
    assert b == ALEX_BATCH, b
    arrays = numpy_params(tr.train_net, seed=0)
    params = params_from_numpy(tr.train_net, arrays, device=dev)
    opt = tr.updater.init(params)
    start = clone_state(params, opt)
    data = synthetic_image_batches(b, (3, 32, 32), seed=0, stream_seed=1)
    batches = [next(data) for _ in range(ALEX_STEPS + 2)]
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for step in range(ALEX_STEPS):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = tr.train_step(params, opt, batches[step], step)
        losses.append(float(m["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        assert per == ALEX_PER_STEP, (step, per)
        assert math.isfinite(losses[-1]), losses
    stacked = {"data": {k: np.stack([bt["data"][k] for bt in batches[-2:]])
                        for k in ("pixel", "label")}}
    params, opt, ms2 = tr.train_steps(params, opt, stacked, ALEX_STEPS, 2,
                                      stacked=True)
    losses += [float(v) for v in ms2["loss"]]
    launches = dict(_kernels.LAUNCHES)
    n_all = ALEX_STEPS + 2
    assert launches == {k: v * n_all for k, v in ALEX_PER_STEP.items()}, \
        launches
    ncap = len(tr._train_graph._graphs)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(step_ms[2:]) / len(step_ms[2:])
    log(f"[alexnet] alexnet.conf b={b} bf16 kSGD: {n_all} replayed steps "
        f"({ALEX_STEPS} train_step + 2 train_steps) of {ncap} CUDA graph, "
        f"launches {launches} (lrn_fwd/lrn_bwd {launches['lrn_fwd']}/"
        f"{launches['lrn_bwd']}, 2 + 2 a replay); losses "
        + " ".join(f"{x:.4f}" for x in losses))
    assert ncap == 1, ncap
    check_alexnet_loss(losses)
    log(f"[alexnet] step {ms:.3f} ms (mean of steps 2..{ALEX_STEPS - 1}, "
        f"host clock, synchronised; steps 0-1 {step_ms[0]:.1f} (warm-up "
        f"and capture), {step_ms[1]:.1f} ms), {b / ms * 1e3:.1f} images/s; "
        f"peak device memory {peak_gib:.2f} GiB")

    # the same steps eagerly from the same start: equal to the bit
    etr = alexnet_trainer(dev, "bfloat16", graphs=False)
    ep, eo = start
    for step in range(ALEX_STEPS):
        ep, eo, _ = etr.train_step(ep, eo, batches[step], step)
    ep, eo, _ = etr.train_steps(ep, eo, stacked, ALEX_STEPS, 2, stacked=True)
    equal = state_equal((params, opt), (ep, eo))
    log(f"[alexnet] {n_all} eager steps and {n_all} replays from one copied "
        f"start (dropout masks, crops and mirrors drawn each step): params "
        f"and momentum equal under torch.equal: {equal}")
    if not equal:
        for k in sorted(params):
            gap = (params[k].float() - ep[k].float()).abs().max().item()
            if gap:
                log(f"[alexnet]   {k}: max|replay - eager| {gap:.3g}")
    assert equal
    alexnet_draws(tr, batches[0])

    # replayed against eager steps, in turns; a profiled step of each
    state = {"graph": [tr, params, opt], "eager": [etr, ep, eo]}
    nxt = [n_all]

    def steps(mode):
        run = state[mode]
        for i in range(ALEX_ROUND_STEPS):
            run[1], run[2], m = run[0].train_step(
                run[1], run[2], batches[i % len(batches)], nxt[0] + i)
        float(m["loss"])
    turns = in_turns({"graph": lambda: steps("graph"),
                      "eager": lambda: steps("eager")}, ALEX_ROUNDS)
    per = {k: [t / ALEX_ROUND_STEPS for t in v] for k, v in turns.items()}
    log(f"[alexnet] {ALEX_ROUNDS} rounds of {ALEX_ROUND_STEPS} steps in "
        f"turns, ms a step (host clock, one fetch a round): replayed "
        f"{[round(x, 4) for x in per['graph']]}, eager "
        f"{[round(x, 4) for x in per['eager']]}; images/s replayed "
        f"{b / min(per['graph']) * 1e3:.1f}, eager "
        f"{b / min(per['eager']) * 1e3:.1f}")
    for mode in ("graph", "eager"):
        run = state[mode]
        wall = min(per[mode])
        profile(f"alexnet_train_step_{mode}", lambda: run[0].train_step(
            run[1], run[2], batches[0], nxt[0]), wall, top=12)
    params, opt = state["graph"][1], state["graph"][2]
    del etr, ep, eo, state, start

    # the step's split on the card's clock, as phase 7
    batch = batches[-1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    names = sorted(params)
    for p in params.values():
        p.requires_grad_(True)
    ev[0].record()
    loss, _, _ = tr.train_net.apply(params, batch, train=True,
                                    compute_dtype=torch.bfloat16,
                                    rng=tr.seed, step=n_all)
    ev[1].record()
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    ev[2].record()
    for p in params.values():
        p.requires_grad_(False)
    tr.updater.update(n_all, dict(zip(names, grads)), params, opt,
                      tr.multipliers)
    ev[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    log(f"[alexnet] split (CUDA events, an eager step on the graph's "
        f"tensors): forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, "
        f"update {upd_ms:.3f} ms")
    MEASURED["alexnet"] = {"ms": ms, "split": (fwd_ms, bwd_ms, upd_ms)}

    # the eval step (scoring forward) through Trainer.evaluate
    _kernels.reset_launches()
    avg = tr.evaluate(params, iter(batches[:1]), 1, tr.test_step)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {**{k: 0 for k in ALEX_PER_STEP},
                                       "lrn_fwd": 2}, _kernels.LAUNCHES
    assert math.isfinite(avg["loss"]) and 0.0 <= avg["precision"] <= 1.0
    n_eval = 10

    def evaluate():
        return tr.evaluate(params, iter(batches[:n_eval]), n_eval,
                           tr.test_step)
    evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate()
    eval_ms = (time.perf_counter() - t0) * 1e3 / n_eval
    log(f"[alexnet] eval step (Trainer.evaluate, {n_eval} batches, host "
        f"clock, metrics on the host): {eval_ms:.3f} ms, "
        f"{b / eval_ms * 1e3:.1f} images/s; loss {avg['loss']:.5f}, "
        f"precision {avg['precision']:.5f}")
    profile("alexnet_eval_step", lambda: tr.test_step(params, batches[0]),
            eval_ms)
    compare_alexnet(dev, arrays)
    pool_ties(dev)
    return launches


POOL_TIES = ((3, 2), (2, 2), (3, 3))    # (kernel, stride)
POOL_SIZES = (32, 13)                   # AlexNet-CIFAR10's pool1 input, odd


def pool_ties(dev):
    """MAX pooling's backward on ReLU-tied inputs (relu(x - 1): 84% zeros,
    whole windows of them) and whole cotangents of 1-8 (whose sums over
    overlapping windows are exact in bf16 in any order), card against
    CPU in f32 and bf16: the
    production backward (autograd of `max_pool2d`: one position per
    window, the first maximum) and the tie-exact oracle
    (`max_pool_tie_exact`: every tied maximum) must route the same
    cotangents to the same positions, equal under `torch.equal`."""
    from singa_tpu_torch.ops import pool
    rng = np.random.default_rng(9)
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, stride in POOL_TIES:
            for size in POOL_SIZES:
                x = np.maximum(rng.standard_normal((64, size, size, 32)) - 1.0,
                               0.0).astype(np.float32)
                oh = pool.pooled_size(size, kernel, stride)
                # small whole cotangents: every sum of them is exact in
                # bf16 too, so equality holds the routing, not a rounding
                g = rng.integers(1, 9, (64, oh, oh, 32)).astype(np.float32)
                tied = 0
                for fn in (pool.max_pool2d, pool.max_pool_tie_exact):
                    res = {}
                    for d in (dev, "cpu"):
                        t = torch.from_numpy(x).to(d, dtype).requires_grad_()
                        y = fn(t, kernel, stride)
                        (dx,) = torch.autograd.grad(
                            y, t, torch.from_numpy(g).to(d, dtype))
                        res[d] = (y.detach().cpu(), dx.cpu())
                    assert torch.equal(res[dev][0], res["cpu"][0]), \
                        (fn.__name__, kernel, stride, size, dtype)
                    assert torch.equal(res[dev][1], res["cpu"][1]), \
                        (fn.__name__, kernel, stride, size, dtype)
                    tied = int((res["cpu"][0] == 0).sum())
                log(f"[alexnet] pool ties k={kernel} s={stride} "
                    f"{size}x{size} {str(dtype)[6:]}: {tied} of "
                    f"{64 * oh * oh * 32} windows all zeros; production "
                    f"and tie-exact backward card = CPU (torch.equal)")


def check_alexnet_loss(losses):
    """The mean loss of the last 5 steps must sit ALEX_MARGIN nats below
    the first step's.  At this config's lr (0.01, momentum 0.9, fc
    biases 1.0) the loss first climbs for a few steps, then comes down."""
    top = max(losses)
    tail = sum(losses[-5:]) / 5
    log(f"[alexnet] loss first {losses[0]:.5f}, peak {top:.5f} at step "
        f"{losses.index(top)}, mean of last 5 {tail:.5f} (must be < first "
        f"- {ALEX_MARGIN}); ln 10 = {math.log(10):.5f}")
    assert tail < losses[0] - ALEX_MARGIN, losses


def compare_alexnet(dev, arrays):
    """The training weights at full width, batch 4, f32, train=False
    (no dropout, no mirror; K5/K6 on the card, their plain versions on
    the CPU): loss and every gradient, card against CPU."""
    from singa_tpu_torch import params_from_numpy, synthetic_image_batches
    batch = next(synthetic_image_batches(4, (3, 32, 32), seed=3))
    res = {}
    for d in (dev, "cpu"):
        tr = alexnet_trainer(d, "float32")
        net = tr.train_net
        params = params_from_numpy(net, arrays, device=d)
        for p in params.values():
            p.requires_grad_(True)
        loss, _, _ = net.apply(params, batch, train=False)
        names = sorted(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        res[d] = (float(loss.detach()), {n: g.float().cpu()
                                for n, g in zip(names, grads)})
    (lc, gc), (lp, gp) = res[dev], res["cpu"]
    log(f"[alexnet] b=4 f32 card loss {lc:.7f}, cpu loss {lp:.7f} (rtol "
        f"{ALEX_LOSS_RTOL})")
    assert abs(lc - lp) <= ALEX_LOSS_RTOL * abs(lp), (lc, lp)
    worst = 0.0
    for name in sorted(gp):
        top = gp[name].abs().max().item()
        gap = (gc[name] - gp[name]).abs().max().item()
        ratio = gap / top if top > 0 else gap
        worst = max(worst, ratio)
        log(f"[alexnet]   {name}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {ratio:.3g} (tol {ALEX_GRAD_RTOL})")
        assert torch.isfinite(gc[name]).all() and ratio <= ALEX_GRAD_RTOL, \
            name
    log(f"[alexnet] card against CPU: worst gradient ratio {worst:.3g}")


# ---------------------------------------------------------------------------
# phase 10: examples/transformer/lm.conf, uncut: kMoE, training, beam
# search and serving

LM_CONF = os.path.join(REPO, "examples", "transformer", "lm.conf")
LM_SEQ = 512
LM_SHAPES = {"data": {"input": (LM_SEQ,), "target": (LM_SEQ,)}}
# two attention layers on the strided flash route, a kLMHead ->
# kSoftmaxLoss head (no K2)
LM_PER_STEP = {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "head_fwd": 0,
               "lrn_fwd": 0, "lrn_bwd": 0}
LM_PROFILED = {"flash_fwd_mma_kernel": 2, "flash_dq_mma_kernel": 2,
               "flash_dkv_mma_kernel": 2, "head_fwd_mma_kernel": 0}
LM_EXACT, LM_ROUNDS, LM_ROUND_STEPS = 10, 3, 10
LM_BATCHES = 10         # synthetic batches, repeated
# card against CPU, bf16.  An H100 showed: 12 of 4096 tokens routed to
# another top-2 set (their router input differs by bf16 ulps); outputs
# within 0.0023 (attn0), 0.0042 (attn1) and 0.0099 (moe1, tokens routed
# alike) of their largest magnitudes; loss 1.5e-5 apart
LM_ROUTED_ALIKE = 0.98  # share of tokens with the same experts and drops
LM_LOSS_RTOL = 1e-3
LM_OUT_RTOL = 2 ** -5   # of each layer output's largest magnitude
LM_GRAD_RTOL = 0.05     # of each gradient's largest magnitude, as phase 6


def lm_trainer(dev, graphs):
    from singa_tpu_torch import Trainer, load_model_config
    cfg = load_model_config(LM_CONF)
    assert cfg.precision == "bfloat16", cfg.precision
    return Trainer(cfg, LM_SHAPES, device=dev, graphs=graphs,
                   log_fn=trainer_log)


def lm_batches(n, seed):
    from singa_tpu_torch import synthetic_token_batches
    data = synthetic_token_batches(8, LM_SEQ, 4096, seed=seed)
    return [next(data) for _ in range(n)]


def routing_of(layer, params, x):
    """The expert set and the kept flags of each token that `layer`
    (kMoE) routes when its input is x, as `moe_ffn` routes them."""
    from singa_tpu_torch.ops import moe
    b, s, e = x.shape
    router = params[layer.router].to(x.dtype)
    cap = moe.capacity(b * s, layer.k, layer.n_exp, layer.capacity_factor)
    r = moe.route(x.reshape(b * s, e), router, layer.k, cap)
    kept = torch.empty_like(r.slot)
    kept[r.order] = (r.slot < layer.n_exp * cap).long()
    experts = torch.sort(r.expert, dim=1).values
    return experts.cpu(), kept.reshape(b * s, layer.k).cpu(), cap


def lm_compare(dev, arrays):
    """(a) lm.conf's forward and every gradient in bf16, card against
    CPU, from the same weights and batch: the share of tokens that kMoE
    routes alike on both, each layer's output (moe1's on the tokens
    routed alike), the loss, and every gradient of the loss over the
    tokens routed alike (plus the aux loss).  kMoE sits in the last
    block, so a token's expert output reaches only its own position's
    loss: leaving the tokens routed apart out of the loss takes their
    routing out of every gradient."""
    from singa_tpu_torch.ops import _kernels
    batch = lm_batches(1, seed=1)[0]
    res = {}
    _kernels.reset_launches()
    for d in (dev, "cpu"):
        tr = lm_trainer(d, False)
        net = tr.train_net
        params = {k: v.requires_grad_(True) for k, v in
                  start(tr, arrays, d)[0].items()}
        loss, metrics, out = net.apply(params, batch, train=True,
                                       compute_dtype=torch.bfloat16,
                                       rng=tr.seed, step=0)
        with torch.no_grad():
            route = routing_of(net.layers["moe1"], params, out["ln1b"])
        res[d] = dict(params=params, out=out, aux=metrics["moe1/aux"],
                      loss=loss.item(), route=route)
        log(f"[lmconf] (a) b=8 s={LM_SEQ} bf16 on {d}: loss "
            f"{res[d]['loss']:.7f}, moe1/aux {metrics['moe1/aux'].item():.7f}")
    card_, cpu = res[dev], res["cpu"]
    (e_c, k_c, cap), (e_p, k_p, _) = card_["route"], cpu["route"]
    same_set = (e_c == e_p).all(dim=1)
    alike = same_set & (k_c == k_p).all(dim=1)
    dropped = int((k_p == 0).sum())
    log(f"[lmconf] (a) moe1 routing, card against CPU: top-2 expert set "
        f"agrees on {float(same_set.float().mean()):.6f} of "
        f"{len(same_set)} tokens ({int((~same_set).sum())} differ); set "
        f"and capacity drops agree on {float(alike.float().mean()):.6f}; "
        f"capacity {cap} per expert, {dropped} of {k_p.numel()} "
        f"assignments dropped on the CPU")
    assert alike.float().mean() >= LM_ROUTED_ALIKE, alike.float().mean()
    for n in ("attn0", "attn1", "moe1"):
        got = card_["out"][n].detach().float().cpu()
        want = cpu["out"][n].detach().float()
        assert torch.isfinite(got).all(), n
        if n == "moe1":
            rows = alike.reshape(got.shape[:2])
            got, want = got[rows], want[rows]
        gap = (got - want).abs().max().item()
        top = want.abs().max().item()
        log(f"[lmconf] (a) {n}: max|card - cpu| {gap:.3g}, max|cpu| "
            f"{top:.3g}, ratio {gap / top:.3g} (tol {LM_OUT_RTOL})"
            + (" on the tokens routed alike" if n == "moe1" else ""))
        assert gap <= LM_OUT_RTOL * top, n
    lc, lp = card_["loss"], cpu["loss"]
    log(f"[lmconf] (a) loss gap |card - cpu| {abs(lc - lp):.3g} (rtol "
        f"{LM_LOSS_RTOL}); aux gap "
        f"{abs(card_['aux'].item() - cpu['aux'].item()):.3g}")
    assert abs(lc - lp) <= LM_LOSS_RTOL * abs(lp), (lc, lp)
    grads = {}
    for d, r in res.items():
        logits, labels = r["out"]["lm_head"], r["out"]["labels"]
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            labels.reshape(-1).long(), reduction="none")
        mask = alike.to(nll.device).float()
        objective = torch.sum(nll * mask) / torch.sum(mask) + r["aux"]
        names = sorted(r["params"])
        g = torch.autograd.grad(objective, [r["params"][n] for n in names])
        grads[d] = {n: x.float().cpu() for n, x in zip(names, g)}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches == LM_PER_STEP, launches
    worst = 0.0
    for name in sorted(grads["cpu"]):
        want, got = grads["cpu"][name], grads[dev][name]
        top = want.abs().max().item()
        gap = (got - want).abs().max().item()
        worst = max(worst, gap / top)
        log(f"[lmconf] (a)   grad {name}: max|card - cpu| {gap:.3g}, "
            f"max|cpu| {top:.3g}, ratio {gap / top:.3g} (tol "
            f"{LM_GRAD_RTOL})")
        assert torch.isfinite(got).all() and gap <= LM_GRAD_RTOL * top, name
    log(f"[lmconf] (a) gradients of the loss over the "
        f"{int(alike.sum())} tokens routed alike: worst ratio {worst:.3g}; "
        f"launches on the card {launches}")


def lm_train(dev, arrays):
    """(b) eager steps against CUDA-graph replays from one copied start,
    equal under torch.equal after LM_EXACT steps and at the end; rounds
    in turns; train_steps; the loss over all steps; a profiled replay by
    kernel name; the MoE's share of a step's device time."""
    from singa_tpu_torch.ops import _kernels
    b = 8
    batches = lm_batches(LM_BATCHES, seed=0)
    runs = {}
    for mode, graphs in (("eager", False), ("graph", None)):
        tr = lm_trainer(dev, graphs)
        assert tr.graphs is (graphs is None), (mode, tr.graphs)
        params, opt = start(tr, arrays, dev)
        runs[mode] = dict(tr=tr, state=(params, opt), ms=[], step=0,
                          losses=[], aux=[])

    def steps(mode, n, check=False):
        run = runs[mode]
        params, opt = run["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            k = run["step"]
            before = dict(_kernels.LAUNCHES)
            params, opt, m = run["tr"].train_step(
                params, opt, batches[k % LM_BATCHES], k)
            loss, aux = torch.stack([m["loss"], m["moe1/aux"]]).tolist()
            run["losses"].append(loss)              # one fetch a step
            run["aux"].append(aux)
            if check:
                per = {x: _kernels.LAUNCHES[x] - before[x] for x in before}
                assert per == LM_PER_STEP, (mode, k, per)
            run["step"] += 1
        run["state"] = (params, opt)
        return (time.perf_counter() - t0) * 1e3 / n

    # the main path: counts from 0 just before, read just after
    _kernels.reset_launches()
    steps("graph", LM_EXACT, check=True)
    launches = dict(_kernels.LAUNCHES)
    captured = [g.launches for g in runs["graph"]["tr"]._train_graph
                ._graphs.values()]
    assert captured == [{k: v for k, v in LM_PER_STEP.items() if v}], \
        captured
    steps("eager", LM_EXACT, check=True)
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    log(f"[lmconf] (b) {LM_EXACT} eager steps and {LM_EXACT} replays from "
        f"one copied start: params and Adam state equal under torch.equal: "
        f"{not gaps}; losses equal: "
        f"{runs['eager']['losses'] == runs['graph']['losses']}")
    for name, gap in sorted(gaps.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[lmconf] (b)   {name}: max|graph - eager| {gap:.3g}")
    assert not gaps, f"{len(gaps)} tensors differ"
    for r in range(LM_ROUNDS):
        for mode in (("eager", "graph") if r % 2 == 0
                     else ("graph", "eager")):
            runs[mode]["ms"].append(steps(mode, LM_ROUND_STEPS))
    for mode, run in runs.items():
        params, opt = run["state"]
        idx = [(run["step"] + i) % LM_BATCHES for i in range(LM_ROUND_STEPS)]
        stacked = {"data": {f: torch.from_numpy(np.stack(
            [batches[i]["data"][f] for i in idx])).to(dev)
            for f in ("input", "target")}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ms = run["tr"].train_steps(params, opt, stacked,
                                                run["step"], LM_ROUND_STEPS,
                                                stacked=True)
        run["losses"] += ms["loss"].tolist()    # the one sync
        run["aux"] += ms["moe1/aux"].tolist()
        run["scan_ms"] = (time.perf_counter() - t0) * 1e3 / LM_ROUND_STEPS
        run["step"] += LM_ROUND_STEPS
        run["state"] = (params, opt)
        prof = profile(f"lm.conf train_step ({mode})",
                       lambda m=mode: steps(m, 1), min(run["ms"]), top=12)
        run["busy"], run["idle"], run["prof"] = \
            prof["busy_ms"], prof["idle"], prof
        if mode == "graph":
            check_replay_profile(prof, LM_PROFILED)
    for mode, run in runs.items():
        log(f"[lmconf] (b) {mode}: step "
            + ", ".join(f"{t:.3f}" for t in run["ms"])
            + f" ms in rounds 1-{LM_ROUNDS} of {LM_ROUND_STEPS} (turns, "
            f"host clock, one fetch a step), "
            + ", ".join(f"{b * LM_SEQ / t * 1e3:.1f}" for t in run["ms"])
            + f" tokens/s; train_steps({LM_ROUND_STEPS}) with one sync "
            f"{run['scan_ms']:.3f} ms a step, "
            f"{b * LM_SEQ / run['scan_ms'] * 1e3:.1f} tokens/s; profiled "
            f"step busy {run['busy']} ms, idle share {run['idle']}")
    gaps = lm_state_gaps(runs["eager"]["state"], runs["graph"]["state"])
    g = runs["graph"]
    log(f"[lmconf] (b) after {g['step']} steps each: equal under "
        f"torch.equal: {not gaps}; losses equal: "
        f"{runs['eager']['losses'] == g['losses']}")
    assert runs["eager"]["step"] == g["step"] and not gaps, \
        sorted(gaps.items(), key=lambda kv: -kv[1])[:8]
    losses, aux = g["losses"], g["aux"]
    tail = sum(losses[-5:]) / 5
    log(f"[lmconf] (b) {len(losses)} steps on {LM_BATCHES} repeated "
        f"batches: loss first {losses[0]:.5f}, mean of last 5 {tail:.5f} "
        f"(must be < first - {LOSS_MARGIN}); moe1/aux first {aux[0]:.6f}, "
        f"last {aux[-1]:.6f}; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    assert all(math.isfinite(x) for x in losses + aux)
    assert tail < losses[0] - LOSS_MARGIN, losses
    MEASURED["lmconf"] = {"ms": min(g["ms"])}
    moe_share(dev, arrays, g)
    return launches


def moe_share(dev, arrays, run):
    """kMoE's forward and backward alone at lm.conf's shape (bf16 input
    (8, 512, 256), the run's params), profiled: its device time split
    into the expert products (cuBLAS) and the dispatch (routing, sort,
    scatter, gather, index_add and their backward), beside the replayed
    step's busy time."""
    from singa_tpu_torch.ops import moe
    tr = run["tr"]
    layer = tr.train_net.layers["moe1"]
    params = run["state"][0]
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((8, LM_SEQ, 256), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    p = {n: params[k].to(torch.bfloat16).detach().requires_grad_(True)
         for n, k in (("router", layer.router), ("w1", layer.w1),
                      ("b1", layer.b1), ("w2", layer.w2), ("b2", layer.b2))}
    dy = torch.randn((8, LM_SEQ, 256), generator=g, device=dev).to(
        torch.bfloat16)

    def fwd_bwd():
        out, aux = moe.moe_ffn(x, p, layer.k, layer.capacity_factor)
        torch.autograd.backward([out, aux], [dy, torch.ones_like(aux)])
    ms = time_ms(fwd_bwd, 10, 2)
    prof = profile("kMoE forward+backward alone", fwd_bwd, ms, top=12)
    if not prof["ms"]:
        log("[lmconf] (b) kMoE share: not measured (no device time)")
        return
    gemm = sum(t for n, t in prof["ms"].items()
               if re.search(r"gemm|cutlass|xmma|sm90", n))
    busy = prof["busy_ms"]
    step = run["busy"]
    log(f"[lmconf] (b) kMoE forward+backward alone: {ms:.3f} ms "
        f"(events), device busy {busy:.3f} ms: expert products "
        f"{gemm:.3f} ms, dispatch {busy - gemm:.3f} ms "
        f"({100 * (busy - gemm) / busy:.1f}%); against the replayed "
        f"step's {step} ms busy: kMoE "
        + (f"{100 * busy / step:.1f}%, its dispatch "
           f"{100 * (busy - gemm) / step:.1f}%" if step else "not measured"))


def lm_decode(dev, arrays):
    """(c) beam_search (4 beams) and greedy generate, 32 new tokens from
    two 64-token prompts, f32 weights, on the card and on the CPU."""
    from singa_tpu_torch import (beam_search, build_net, generate,
                                 load_model_config, params_from_numpy)
    from singa_tpu_torch.models.generate import forward_cached, init_cache
    from singa_tpu_torch.ops import _kernels
    net = build_net(load_model_config(LM_CONF), "kTest", LM_SHAPES)
    prompts = np.random.default_rng(13).integers(0, 4096, (2, 64))
    res = {}
    _kernels.reset_launches()
    for d in (dev, "cpu"):
        params = params_from_numpy(net, arrays, device=d)
        t0 = time.perf_counter()
        with torch.no_grad():
            toks, scores = beam_search(net, params, prompts, 32, num_beams=4)
            greedy = generate(net, params, prompts, 32)
        res[d] = dict(beam=toks.cpu(), scores=scores.cpu(),
                      greedy=greedy.cpu(), params=params)
        log(f"[lmconf] (c) beam_search (4 beams) and greedy, 2 prompts of "
            f"64, 32 new tokens, f32 on {d}: "
            f"{time.perf_counter() - t0:.2f} s; beam scores "
            + ", ".join(f"{v:.5f}" for v in scores.tolist()))
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    card_, cpu = res[dev], res["cpu"]
    for what in ("beam", "greedy"):
        got, want = card_[what], cpu[what]
        assert got.shape == (2, 32) and ((got >= 0) & (got < 4096)).all()
        for i in range(2):
            same = torch.equal(got[i], want[i])
            line = (f"[lmconf] (c) {what} prompt {i}: card and CPU tokens "
                    f"equal: {same}")
            if not same:
                k = int((got[i] != want[i]).nonzero()[0, 0])
                seq = torch.cat([torch.from_numpy(prompts[i]),
                                 want[i][:k]])[None]
                with torch.no_grad():
                    logits, _ = forward_cached(
                        net, cpu["params"], seq,
                        init_cache(net, 1, seq.shape[1], device="cpu"), 0)
                top2 = logits[0, -1].topk(2).values
                line += (f"; first divergence at token {k}, where the "
                         f"CPU's top-2 logit gap is "
                         f"{float(top2[0] - top2[1]):.3g}")
            log(line)
    if torch.equal(card_["beam"], cpu["beam"]):
        gap = (card_["scores"] - cpu["scores"]).abs().max().item()
        log(f"[lmconf] (c) beam scores max|card - cpu| {gap:.3g} (tol 1e-3)")
        assert gap <= 1e-3, gap
    assert torch.isfinite(card_["scores"]).all()


LM_CB = dict(cb="on", cb_slots=8, cb_block_len=16, cb_prompt_cap=256,
             max_new_tokens=64, queue_capacity=64, request_timeout_s=600.0)


def lm_serve(dev, arrays):
    """(d) lm.conf served with f32 weights: one engine bucket (8, 128) x
    32 new tokens as a CUDA graph against an eager engine, then a
    continuous-batching run of 24 requests (8 slots) replayed against
    eager: every request served, the same answers (a MoE's capacity is
    shared by the rows of a call, so answers are held against the same
    traffic eager, not against generate)."""
    from singa_tpu_torch import (InferenceEngine, ServeSpec, build_net,
                                 load_model_config, params_from_numpy)
    from singa_tpu_torch.ops import _kernels
    net = build_net(load_model_config(LM_CONF), "kTest", LM_SHAPES)
    params = params_from_numpy(net, arrays, device=dev)
    rng = np.random.default_rng(17)
    prompts = [list(rng.integers(0, 4096, n))
               for n in (128, 100, 77, 64, 50, 33, 17, 5)]
    spec = ServeSpec(buckets=((8, 128),), max_new_tokens=32)
    _kernels.reset_launches()
    engines = {}
    for name, graphs in (("graph", None), ("eager", False)):
        eng = InferenceEngine(net, spec, params, device=dev, log_fn=log,
                              graphs=graphs)
        n = eng.warmup(("generate",))
        assert n == (1 if graphs is None else 0), (name, n)
        engines[name] = eng
    out = {k: np.stack(e.answer("generate", prompts))
           for k, e in engines.items()}
    assert out["graph"].shape == (8, 32) and \
        ((out["graph"] >= 0) & (out["graph"] < 4096)).all()
    assert np.array_equal(out["graph"], out["eager"]), \
        "replayed bucket tokens != eager"
    ms = in_turns({k: (lambda e=e: e.answer("generate", prompts))
                   for k, e in engines.items()})
    for k in ("eager", "graph"):
        log(f"[lmconf] (d) bucket (8, 128) x 32 new tokens, {k}: "
            + ", ".join(f"{t:.3f}" for t in ms[k])
            + " ms in rounds 1-3 (turns), "
            + ", ".join(f"{8 * 32 / t * 1e3:.1f}" for t in ms[k])
            + " tokens/s (prefill included); replay equals eager")
    prof = profile("lm.conf bucket generate (graph)",
                   lambda: engines["graph"].answer("generate", prompts),
                   min(ms["graph"]))
    log(f"[lmconf] (d) bucket generate (graph): idle share {prof['idle']}")
    del engines
    crng = np.random.default_rng(19)
    cprompts = [crng.integers(0, 4096, n).astype(np.int32)
                for n in crng.integers(16, 257, 24)]
    cmax = [int(m) for m in crng.integers(8, 65, 24)]
    answers = {}
    for name, graphs in (("graph", None), ("eager", False)):
        eng, _, outs, wall = serve_cb(net, params, dev, cprompts, cmax,
                                      graphs, **LM_CB)
        answers[name] = [o["tokens"] for o in outs]
        ntok = sum(len(a) for a in answers[name])
        snap = eng.stats.snapshot()
        log(f"[lmconf] (d) cb {name}: {len(outs)} of 24 requests served "
            f"(finish length), 0 failed, {snap['cb_steps']} scheduler "
            f"steps, {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} "
            f"generated tokens/s; latency p50/p99 {snap['p50_latency_ms']}"
            f"/{snap['p99_latency_ms']} ms")
        del eng
    assert answers["graph"] == answers["eager"], "cb replay != eager"
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log("[lmconf] (d) cb replayed answers equal eager ones, all 24")


def phase_lmconf(dev):
    """Phase 10: examples/transformer/lm.conf uncut (B=8, S=512, V=4096,
    E=256, 2 blocks, the second a kMoE of 4 experts top-2, bf16, Adam)
    with numpy-seeded weights."""
    from singa_tpu_torch import build_net, load_model_config, numpy_params
    arrays = numpy_params(build_net(load_model_config(LM_CONF), "kTrain",
                                    LM_SHAPES), seed=0)
    lm_compare(dev, arrays)
    launches = lm_train(dev, arrays)
    lm_decode(dev, arrays)
    lm_serve(dev, arrays)
    return launches



# phase 11: the serving front ends, on lm.conf uncut, served in f32
FRONT_SPEC = "buckets=1x16/4x32/8x64,max_new_tokens=32,eos_id=2"
FRONT_CB = ",cb=on,cb_slots=8,cb_block_len=16"
FRONT_N = 16            # requests of the measured set, prompts 8-64
FRONT_WAIT = 120.0      # every wait of this phase is bounded


def front_train(dev, ws):
    """lm.conf, 10 Adam steps replayed by the port's Trainer from numpy
    seed 0; the step-5 snapshot goes to `ws` (npz), the step-10 state
    comes back for a save while the server is under load."""
    from singa_tpu_torch import (CheckpointManager, numpy_params,
                                 state_to_numpy)
    tr = lm_trainer(dev, None)
    assert tr.graphs == (tr.device.type == "cuda"), \
        "lm.conf's train step must be captured on the card"
    params, opt = start(tr, numpy_params(tr.train_net, seed=0), dev)
    mgr = CheckpointManager(ws, log_fn=log)
    losses = []
    for step, batch in enumerate(lm_batches(10, seed=2)):
        params, opt, m = tr.train_step(params, opt, batch, step)
        losses.append(float(m["loss"]))
        if step + 1 == 5:
            mgr.save(5, params, opt)
    assert all(math.isfinite(x) for x in losses), losses
    log(f"[front] 11 lm.conf trained 10 replayed steps, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; step 5 saved to the "
        f"workspace (npz)")
    return state_to_numpy(params, opt)


def front_cli(dev, ws):
    """11a: the CLI's `serve ... --smoke 8` (`main(argv)` in this
    process), with the static buckets and with cb=on: each must exit 0,
    serve the workspace's step 5 and print its snapshot."""
    torch.cuda.empty_cache()
    for name, extra in (("buckets", ""), ("cb=on", FRONT_CB)):
        argv = ["serve", "-model_conf", LM_CONF, "--workspace", ws,
                "--serve_spec", FRONT_SPEC + extra, "--smoke", "8"]
        t0 = time.perf_counter()
        code, text = run_main(argv, dev)
        wall = time.perf_counter() - t0
        if code != 0:
            print(text[-6000:], file=sys.stderr)
        assert code == 0, (name, code)
        snap = json.loads([ln for ln in text.splitlines()
                           if ln.startswith("{")][-1])
        assert snap["params_step"] == 5, snap
        assert snap["completed"] == 8 and snap["failed"] == 0, snap
        assert snap["compiles"] > 0, "the CLI did not capture on the card"
        log(f"[front] 11a CLI serve --smoke 8 ({name}), main(argv) in "
            f"this process: exit 0 in {wall:.3f} s wall (load, capture, 8 "
            f"requests), step 5, {snap['generated_tokens']} tokens, "
            f"{snap['compiles']} CUDA graphs captured, latency p50/p99 "
            f"{snap['p50_latency_ms']}/{snap['p99_latency_ms']} ms")
        print(f"[front] 11a snapshot ({name}): {json.dumps(snap)}",
              flush=True)


def front_eager(net, arrays, dev, spec, prompts):
    """Each prompt alone through an eager engine's scheduler."""
    from singa_tpu_torch import InferenceEngine, params_from_numpy
    from singa_tpu_torch.serve import ContinuousScheduler
    eng = InferenceEngine(net, spec, params_from_numpy(net, arrays,
                                                       device=dev),
                          device=dev, log_fn=log, graphs=False)
    sched = ContinuousScheduler(eng, log_fn=log).start()
    try:
        return [sched.submit(p).wait(FRONT_WAIT)["tokens"] for p in prompts]
    finally:
        sched.stop()


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def front_clients(server):
    """name -> prompt -> (tokens, host clock at the first token or
    None), through each front end."""
    import urllib.request
    from singa_tpu_torch.serve.wire import BinaryEngineHandle
    host, port = server.address
    handle = BinaryEngineHandle("e0", server.wire_address)

    def http(p, stream=False):
        body = {"tokens": [int(t) for t in p], "stream": stream}
        req = urllib.request.Request(f"http://{host}:{port}/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=FRONT_WAIT) as r:
            if not stream:
                return json.loads(r.read())["tokens"], None
            return streamed(json.loads(x) for x in r if x.strip())

    def streamed(events):
        toks, first, last = [], None, None
        for ev in events:
            last = ev
            if "token" in ev:
                first = first or time.perf_counter()
                toks.append(ev["token"])
        assert last.get("done"), last
        return toks, first

    return handle, {
        "in process": lambda p: (server.generate(
            p, timeout=FRONT_WAIT)["tokens"], None),
        "HTTP": http,
        "HTTP ndjson stream": lambda p: http(p, stream=True),
        "wire": lambda p: (handle.request("generate", p,
                                          timeout=FRONT_WAIT)["tokens"],
                           None),
        "wire stream": lambda p: streamed(
            handle.request_stream(p, timeout=FRONT_WAIT))}


def front_inprocess(dev, ws, state10):
    """11b-11d: an InferenceServer on the card (cb=on, the static
    buckets, HTTP and the wire) over the workspace."""
    import urllib.request

    from singa_tpu_torch import (CheckpointManager, build_net,
                                 load_model_config, obs)
    from singa_tpu_torch.obs import perf
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.serve import (InferenceEngine, InferenceServer,
                                       ServeSpec)
    net = build_net(load_model_config(LM_CONF), "kTrain", LM_SHAPES)
    spec = ServeSpec.parse(FRONT_SPEC + FRONT_CB + ",reload_poll_s=0.05,"
                           "request_timeout_s=120")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 4096, n).astype(np.int32)
               for n in rng.integers(8, 65, FRONT_N)]
    p5 = CheckpointManager(ws, log_fn=log).restore()[0]
    want5 = front_eager(net, p5, dev, spec, prompts)
    want10 = front_eager(net, state10[0], dev, spec, prompts)
    assert want5 != want10, "steps 5 and 10 answer alike"
    _kernels.reset_launches()
    engine = InferenceEngine(net, spec, device=dev, workspace=ws,
                             log_fn=log)
    server = InferenceServer(engine, port=0, wire_on=True, log_fn=log)
    t0 = time.perf_counter()
    server.start()
    log(f"[front] 11b server started in {time.perf_counter() - t0:.3f} s "
        f"(load step {engine.params_step}, {engine.stats.compiles} CUDA "
        f"graphs: cb prefill, cb decode, 3 predict buckets)")
    try:
        # cb prefill, cb decode, predict at 3 buckets
        assert engine.params_step == 5
        assert engine.stats.compiles == (5 if engine.graphs else 0)
        warm, anomalies = engine.stats.compiles, perf.watch().anomalies
        ptrs = {k: v.data_ptr() for k, v in engine.params.items()}
        host, port = server.address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert r.status == 200 and health["ok"], health
        assert health["wire_port"] == server.wire_address[1], health
        handle, clients = front_clients(server)
        try:
            front_measure(clients, prompts, want5)
            prof = profile("one in-process request (cb, 32 new tokens)",
                           lambda: server.generate(prompts[0]),
                           host_ms(lambda: server.generate(prompts[0]),
                                   n=3))
            log(f"[front] 11b one in-process request: idle share "
                f"{prof['idle']}")
        finally:
            handle.close()
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=30) as r:
            metrics = r.read().decode()
        names = ["singa_wire_frames_rx_total", "singa_serve_completed_total"]
        if engine.graphs:      # captures and device memory: on the card
            names += ['singa_compiles_total{program="cb_prefill"}',
                      'singa_compiles_total{program="cb_decode"}',
                      'singa_compiles_total{program="predict"}',
                      "singa_hbm_live_bytes"]
        for name in names:
            assert name in metrics, name
        log("[front] 11b /healthz 200 advertising the wire port; /metrics "
            "carries singa_wire_*, the serve counters and the captures "
            "per program: " + ", ".join(
                ln for ln in metrics.splitlines()
                if ln.startswith("singa_compiles_total")))
        obs_dir = os.path.join(ws, "obs")
        obs.enable(obs.ObsSpec(events=os.path.join(obs_dir, "events.jsonl"),
                               trace_ring=65536))
        try:
            front_reload(server, ws, state10, prompts, want10)
        finally:
            obs.disable()
        with open(os.path.join(obs_dir, "events.jsonl")) as f:
            outcomes = [ev["outcome"] for ev in map(json.loads, f)
                        if ev["kind"] == "serve.reload"]
        assert outcomes == ["reloaded", "refused"], outcomes
        assert engine.stats.compiles == warm, "captured after warm-up"
        assert perf.watch().anomalies == anomalies
        assert {k: v.data_ptr() for k, v in engine.params.items()} == ptrs
        log(f"[front] 11c captures after warm-up: 0 (perf anomalies "
            f"{perf.watch().anomalies - anomalies}); every param's "
            f"data_ptr unchanged; serve.reload events {outcomes}")
    finally:
        server.stop()
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log("[front] 11 the serving path launched none of K1-K6 (f32, "
        "prompts under 128, kLMHead -> kSoftmaxLoss)")


def front_measure(clients, prompts, want):
    """The same requests, one at a time, through each front end in two
    rounds (the order flips): equal tokens everywhere, equal to the
    eager engine; per-request latency p50/p99 and tokens/s."""
    lat = {k: [] for k in clients}
    ttft = {k: [] for k in clients}
    ntok = {k: 0 for k in clients}
    for rnd in range(2):
        for name in (list(clients) if rnd == 0 else list(clients)[::-1]):
            for p, w in zip(prompts, want):
                t0 = time.perf_counter()
                got, first = clients[name](p)
                lat[name].append(time.perf_counter() - t0)
                assert got == w, (name, got, w)
                ntok[name] += len(got)
                if first is not None:
                    ttft[name].append(first - t0)
    for name in clients:
        log(f"[front] 11b {name}: {len(lat[name])} requests one at a time, "
            f"latency p50 {_pct(lat[name], 50):.3f} ms, p99 "
            f"{_pct(lat[name], 99):.3f} ms, mean "
            f"{1e3 * sum(lat[name]) / len(lat[name]):.3f} ms, "
            f"{ntok[name] / sum(lat[name]):.1f} tokens/s; tokens equal "
            f"the eager engine's"
            + (f"; first token p50 {_pct(ttft[name], 50):.3f} ms, p99 "
               f"{_pct(ttft[name], 99):.3f} ms" if ttft[name] else ""))
    base = np.median(lat["in process"])
    for name in clients:
        if name != "in process":
            log(f"[front] 11b front-end cost of {name}: "
                f"{1e3 * (np.median(lat[name]) - base):.3f} ms per request "
                f"over in process (medians)")


def front_reload(server, ws, state10, prompts, want10):
    """11c: save step 10 under load and wait for the reload; 11d: a
    diverged step-15 snapshot is refused and /healthz turns 503."""
    import threading
    import urllib.error
    import urllib.request

    from singa_tpu_torch import CheckpointManager
    engine = server.engine
    host, port = server.address
    stop = threading.Event()
    done, errors = [], []

    def client(i):
        k = i
        while not stop.is_set():
            p = prompts[k % len(prompts)]
            k += 1
            try:
                if i % 3 == 2:
                    body = json.dumps({"tokens": [int(t) for t in p]})
                    req = urllib.request.Request(
                        f"http://{host}:{port}/generate",
                        data=body.encode())
                    with urllib.request.urlopen(req,
                                                timeout=FRONT_WAIT) as r:
                        out = json.loads(r.read())
                else:
                    out = server.generate(p, timeout=FRONT_WAIT)
                done.append((time.perf_counter(), out["step"]))
            except Exception as e:  # noqa: BLE001 — counted, then raised
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    before = len(done)
    t_save = time.perf_counter()
    CheckpointManager(ws, log_fn=log).save(10, *state10)
    t_saved = time.perf_counter()
    while engine.params_step != 10 and \
            time.perf_counter() - t_save < FRONT_WAIT:
        time.sleep(0.005)
    t_live = time.perf_counter()
    assert engine.params_step == 10, "step 10 was not reloaded"
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(FRONT_WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert engine.stats.reloads == 1 and engine.stats.reload_failures == 0
    first_new = min(t for t, s in done if s == 10)
    log(f"[front] 11c hot reload under load (6 clients, 4 in process, 2 "
        f"HTTP): {len(done)} requests completed, 0 failed, {before} before "
        f"the save; save {1e3 * (t_saved - t_save):.3f} ms, save to step "
        f"10 live {1e3 * (t_live - t_save):.3f} ms, save to the first "
        f"answer on step 10 {1e3 * (first_new - t_save):.3f} ms; the "
        f"reload's copy_ into the captured params "
        f"{engine.reload_copy_ms:.3f} ms")
    got = [server.generate(p, timeout=FRONT_WAIT) for p in prompts]
    assert all(o["step"] == 10 for o in got)
    assert [o["tokens"] for o in got] == want10, \
        "answers after the reload != an eager engine over step 10"
    log(f"[front] 11c after the reload: {len(got)} answers equal an eager "
        f"engine built over step 10's params")
    p15, o15 = state10
    CheckpointManager(ws, log_fn=log).save(
        15, {k: v * 0.5 for k, v in p15.items()}, o15,
        health={"verdict": "diverged"})
    t0 = time.perf_counter()
    while not engine.stats.reloads_refused and \
            time.perf_counter() - t0 < FRONT_WAIT:
        time.sleep(0.005)
    assert engine.stats.reloads_refused == 1 and engine.params_step == 10
    try:
        urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30)
        raise AssertionError("/healthz answered 200 over stale params")
    except urllib.error.HTTPError as e:
        code, health = e.code, json.loads(e.read())
    assert code == 503 and health["status"] == "degraded", health
    assert "reload refused" in health["reasons"][0], health
    out = server.generate(prompts[0], timeout=FRONT_WAIT)
    assert out["step"] == 10 and out["tokens"] == want10[0]
    log(f"[front] 11d diverged step 15 refused: /healthz {code} "
        f"({health['reasons'][0]}); still serving step 10, answers "
        f"unchanged")


def phase_front(dev):
    """Phase 11: the serving front ends on lm.conf uncut, served in f32
    from a workspace the port's Trainer wrote."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ws = tempfile.mkdtemp(prefix="front-", dir=os.path.join(REPO, "build"))
    try:
        state10 = front_train(dev, ws)
        front_cli(dev, ws)
        front_inprocess(dev, ws, state10)
    finally:
        shutil.rmtree(ws, ignore_errors=True)


# -- phase 12: training as users run it -------------------------------------
CLI_STEPS = 40          # the supervised lm.conf runs
CLI_CHUNK = 8
CLI_CKPT = 8            # the cadence written into the copy of lm.conf
CLI_FAULTS = "ckpt.save@1:torn,step.train@2:preempt"
CLI_SPIKE_STEPS = 16
ALEX_CLI_STEPS = 4
ALEX_RECORDS = 2048
FEED_ROUNDS = 2
HEALTH_ROUNDS, HEALTH_STEPS = 3, 16
# the CLI as `python -m singa_tpu_torch.main` runs it (its `__main__` is
# `sys.exit(main())`), with the kernel launch counts written to a file
CLI_WRAPPER = """
import json, sys
from singa_tpu_torch.main import main
from singa_tpu_torch.ops import _kernels
out, dev, argv = sys.argv[1], sys.argv[2] or None, sys.argv[3:]
code = main(argv, device=dev)
with open(out, "w") as f:
    json.dump({"code": code, "launches": _kernels.LAUNCHES}, f)
sys.exit(code)
"""


def cli_conf(tmp, conf=None, every=CLI_CKPT):
    """A copy of lm.conf (or `conf`) with a checkpoint every `every`
    steps: the shipped config sets none, and `--workspace` alone then
    saves only at the end, so a fault would have nothing to resume."""
    with open(conf or LM_CONF) as f:
        text = re.sub(r"(?m)^checkpoint_frequency:.*$", "", f.read())
    path = os.path.join(tmp, "lm_ckpt.conf")
    with open(path, "w") as f:
        f.write(f"checkpoint_frequency: {every}\n" + text)
    return path


def cli_argv(conf, ws, steps=CLI_STEPS, *extra):
    return ["-model_conf", conf, "--synthetic", "--steps", str(steps),
            "--workspace", ws, "--scan_chunk", str(CLI_CHUNK), *extra]


def run_main(argv, dev, trace=None):
    """`singa_tpu_torch.main.main(argv)` in this process; returns (exit
    code, the log it printed).  `trace` turns telemetry on and writes
    the span trace there."""
    import contextlib
    import io
    from singa_tpu_torch.main import main as tmain
    if trace:
        argv = [*argv, "--obs", "on", "--obs_spec", f"trace={trace}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        code = tmain(argv, device=None if dev == "cuda" else dev)
    return code, buf.getvalue()


def run_main_launches(argv, dev):
    """`run_main`, and the kernel launches the run made."""
    from singa_tpu_torch.ops import _kernels
    before = dict(_kernels.LAUNCHES)
    code, text = run_main(argv, dev)
    return code, text, {k: n - before.get(k, 0)
                        for k, n in _kernels.LAUNCHES.items()}


def run_one(argv, dev, tag):
    """A one-process CLI run that a check holds a group against, through
    `main(argv)` in this process (no process start): its log; it must
    exit 0."""
    t0 = time.perf_counter()
    code, text = run_main(argv, dev)
    assert code == 0, (tag, text[-3000:])
    log(f"[time] in process {tag}: {time.perf_counter() - t0:.2f} s")
    return text


def snapshot(ws, step=None):
    """(params, opt_state, step) of a workspace's newest (or `step`'s)
    snapshot, as CPU tensors."""
    from singa_tpu_torch import CheckpointManager
    p, o, s = CheckpointManager(ws, log_fn=lambda m: None).restore(step)
    t = lambda d: {k: (t(v) if isinstance(v, dict)  # noqa: E731
                       else torch.from_numpy(np.asarray(v)))
                   for k, v in d.items()}
    return t(p), t(o), s


def state_equal(a, b) -> bool:
    """Two (nested) dicts or tuples of tensors equal under torch.equal."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(state_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(state_equal, a, b))
    return torch.equal(a.cpu(), b.cpu())


def expect_in(text, *needles):
    for n in needles:
        assert n in text, (n, text[-3000:])


def cli_trainer(conf, dev, health=None, graphs=None):
    from singa_tpu_torch import Trainer, load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    cfg = load_model_config(conf)
    return Trainer(cfg, discover_input_shapes(cfg, force_synthetic=True),
                   device=dev, log_fn=lambda m: None, health=health,
                   graphs=graphs)


def cli_stream(conf, skip=()):
    """The CLI's synthetic training stream (seed 0), without the stream
    indices in `skip`."""
    from singa_tpu_torch import load_model_config
    from singa_tpu_torch.data import resolve_data_source
    cfg = load_model_config(conf)
    p = next(l for l in cfg.neuralnet.layer if l.type == "kSequenceData")
    it, _ = resolve_data_source(cfg, p.seqdata_param.batchsize, seed=0,
                                force_synthetic=True)
    try:
        for i, b in enumerate(it):
            if i not in skip:
                yield b
    finally:
        it.close()


def train_a(dev, conf, ws, expect_launches):
    """12a: the supervised CLI in a subprocess, with a torn save and a
    preemption: exit 0, the torn snapshot skipped, a resume from step
    CLI_CKPT, a workspace the port restores, and (on the card) 2 K1,
    K3 and K4 launches a step."""
    out = os.path.join(ws, "launches.json")
    argv = cli_argv(conf, ws, CLI_STEPS, "--max-restarts", "2",
                    "--feeder", "on", "--fault_spec", CLI_FAULTS)
    t0 = time.perf_counter()
    cmd, started = spawn([sys.executable, "-c", CLI_WRAPPER, out,
                          "" if dev == "cuda" else dev, *argv],
                         "12a the supervised lm.conf CLI")
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    started(res.returncode)
    wall = time.perf_counter() - t0
    text = res.stdout + res.stderr
    if res.returncode != 0:
        print(text[-8000:], file=sys.stderr)
    assert res.returncode == 0, res.returncode
    expect_in(text, "checkpoint step 16 is corrupt or partial",
              f"resumed from step {CLI_CKPT} (attempt 2)",
              "preemption at", "training done")
    with open(out) as f:
        launches = json.load(f)["launches"]
    # attempt 1 trains steps [0, 16), attempt 2 [8, 40)
    trained = 2 * CLI_CKPT + (CLI_STEPS - CLI_CKPT)
    if expect_launches:
        want = {k: 0 for k in launches}
        want.update({k: 2 * trained for k in ("flash_fwd", "flash_dq",
                                              "flash_dkv")})
        assert launches == want, launches
    tr = cli_trainer(conf, dev)
    p, o = tr.init(0)
    p, o, step = tr.resume(p, o, ws)
    assert step == CLI_STEPS and all(torch.isfinite(v).all()
                                     for v in p.values())
    log(f"[cli] 12a python -m singa_tpu_torch.main {' '.join(argv[:2])} "
        f"... --fault_spec '{CLI_FAULTS}' --feeder on: exit 0 in "
        f"{wall:.3f} s wall (process start included); the torn step-16 "
        f"snapshot skipped, resumed from step {CLI_CKPT}; {trained} steps "
        f"trained for {CLI_STEPS}; launches {launches}; the workspace "
        f"restores in the port at step {step}")
    return launches


def trace_spans(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def train_b(dev, conf, ws_sup, ws_ref, ws_a):
    """12b: the same supervised run through main(argv) in this process
    (with telemetry on, for 12g's times), against an uninterrupted run:
    final params and Adam state equal under torch.equal; 12a's workspace
    too."""
    trace = os.path.join(ws_sup, "trace.json")
    code, text = run_main(cli_argv(conf, ws_sup, CLI_STEPS,
                                   "--max-restarts", "2", "--feeder", "on",
                                   "--fault_spec", CLI_FAULTS), dev,
                          trace=trace)
    assert code == 0, text[-3000:]
    expect_in(text, f"resumed from step {CLI_CKPT} (attempt 2)")
    code, text = run_main(cli_argv(conf, ws_ref, CLI_STEPS, "--feeder", "on"),
                          dev)
    assert code == 0, text[-3000:]
    sup, ref, cli = snapshot(ws_sup), snapshot(ws_ref), snapshot(ws_a)
    assert sup[2] == ref[2] == cli[2] == CLI_STEPS
    for name, got in (("in process", sup), ("12a's subprocess", cli)):
        assert state_equal(got[0], ref[0]), name
        assert state_equal(got[1], ref[1]), name
    # the same faults on a trainer held here: its restart copies the
    # restored state into the captured tensors and captures nothing anew
    from singa_tpu_torch.core.supervisor import Supervisor
    from singa_tpu_torch.utils.faults import Backoff, FaultSchedule, inject
    from singa_tpu_torch.utils.health import HealthMonitor
    tr = cli_trainer(conf, dev, health=HealthMonitor(log_fn=lambda m: None))
    tr.cfg.train_steps = CLI_STEPS
    sup = Supervisor(tr, os.path.join(ws_sup, "held"), max_restarts=2,
                     backoff=Backoff(base=0.0, cap=0.0, jitter=0.0),
                     log=lambda m: None)
    with inject(FaultSchedule.parse(CLI_FAULTS)):
        p, o, _ = sup.run(lambda: cli_stream(conf), seed=0,
                          scan_chunk=CLI_CHUNK)
    assert [f.kind for f in sup.failures] == ["preemption"], sup.failures
    ncap = len(tr._train_graph._graphs) if tr.graphs else 0
    assert ncap == (1 if dev == "cuda" else 0), ncap
    assert state_equal(p, ref[0]) and state_equal(o, ref[1])
    del tr, sup
    spans = trace_spans(trace)
    att = sorted((e for e in spans if e["name"] == "supervisor.attempt"),
                 key=lambda e: e["ts"])
    assert len(att) == 2, [e["args"] for e in att]
    fail = att[0]["ts"] + att[0]["dur"]

    def first_after(name):
        return min(e["ts"] + e["dur"] for e in spans
                   if e["name"] == name and e["ts"] >= fail)
    saves = [e["dur"] / 1e3 for e in spans if e["name"] == "ckpt.save"]
    restores = [e["dur"] / 1e3 for e in spans
                if e["name"] == "ckpt.restore"]
    log(f"[cli] 12b supervised main(argv) in process equals an "
        f"uninterrupted run after {CLI_STEPS} steps (params and Adam "
        f"state, torch.equal), and so does 12a's workspace; a Supervisor "
        f"on a trainer held here restarts once and equals it too, with "
        f"{ncap} CUDA graph captured in both attempts")
    log(f"[cli] 12g preemption -> first chunk after the restore "
        f"dispatched {(first_after('trainer.chunk') - fail) / 1e3:.3f} ms, "
        f"its {CLI_CHUNK} steps' metrics drained "
        f"{(first_after('trainer.drain') - fail) / 1e3:.3f} ms (init, "
        f"restore, stream fast-forward, first chunk; from the span trace)")
    log(f"[cli] 12g lm.conf snapshot save (params + Adam state, f32 npz, "
        f"fsync): {len(saves)} saves, mean {np.mean(saves):.3f} ms, max "
        f"{max(saves):.3f} ms; restore: {len(restores)}, mean "
        f"{np.mean(restores):.3f} ms, max {max(restores):.3f} ms")


def train_c(dev, conf, ws):
    """12c: NaN gradients at step 13 with blamed batches and an LR
    backoff: the fatal window is never saved (its save refused), the
    run rolls back to step 8 with lr_scale 0.5, and lands equal to a
    manual baseline making the same decisions; a replay after the
    backoff equals an eager step."""
    from singa_tpu_torch.utils.faults import FaultSchedule, inject
    from singa_tpu_torch.utils.health import (HealthMonitor,
                                              NumericDivergence)
    from singa_tpu_torch import CheckpointManager
    # the refusal, on a captured trainer on the card
    mon = HealthMonitor(log_fn=lambda m: None)
    tr = cli_trainer(conf, dev, health=mon)
    tr.cfg.train_steps = CLI_STEPS
    p, o = tr.init(0)
    wsr = os.path.join(ws, "refused")
    try:
        with inject(FaultSchedule.parse("step.grad@13:nan")):
            tr.run(p, o, cli_stream(conf), seed=0, workspace=wsr,
                   scan_chunk=CLI_CHUNK)
        raise AssertionError("no NumericDivergence")
    except NumericDivergence as e:
        assert (e.step, e.status, e.metric) == (13, "nonfinite",
                                                "grad_norm"), e
    ck = CheckpointManager(wsr, log_fn=lambda m: None)
    assert ck.available_steps() == [CLI_CKPT], ck.available_steps()
    assert not mon.ok_to_save()
    st = tr._state or {"params": p, "opt": o}
    assert tr._save_checkpoint(ck, 16, st["params"], st["opt"]) is False
    assert ck.available_steps() == [CLI_CKPT]
    del tr
    # the CLI's rescue
    wsc = os.path.join(ws, "rescue")
    code, text = run_main(cli_argv(
        conf, wsc, CLI_STEPS, "--max-restarts", "2", "--fault_spec",
        "step.grad@13:nan", "--health_spec", "blame_batches=2,lr_backoff=0.5"),
        dev)
    assert code == 0, text[-3000:]
    expect_in(text, "numeric divergence at step 13",
              "blaming batches [13, 15)", "LR backoff x0.5 (scale now 0.5)",
              f"resumed from step {CLI_CKPT} (attempt 2)")
    got = snapshot(wsc)
    # the baseline: CLI_CKPT steps, then lr x0.5 without stream batches
    # 13 and 14, as replays and eagerly
    finals = {}
    for graphs in (None, False):
        tr = cli_trainer(conf, dev, graphs=graphs)
        tr.cfg.train_steps = CLI_CKPT
        p, o = tr.init(0)
        it = cli_stream(conf)
        p, o, _ = tr.run(p, o, it, seed=0, scan_chunk=CLI_CKPT)
        it.close()
        tr.cfg.train_steps = CLI_STEPS
        tr.updater.lr_scale = 0.5
        it = cli_stream(conf, skip=(13, 14))
        for _ in range(CLI_CKPT):
            next(it)
        p, o, _ = tr.run(p, o, it, seed=0, start_step=CLI_CKPT,
                         scan_chunk=CLI_CHUNK)
        finals["replay" if graphs is None else "eager"] = (p, o)
        del tr
    for mode, (p, o) in finals.items():
        assert state_equal(got[0], p) and state_equal(got[1], o), mode
    log(f"[cli] 12c step.grad@13:nan: NumericDivergence (13, nonfinite, "
        f"grad_norm) on the card, the window's save refused (snapshots "
        f"{ck.available_steps()}); the CLI rescue (blame_batches=2, "
        f"lr_backoff=0.5) rolled back to step {CLI_CKPT} with lr_scale "
        f"0.5 and equals its manual baseline, replayed and eager, after "
        f"{CLI_STEPS} steps (torch.equal)")


def train_d(dev, conf, ws):
    """12d: a spike at step 9 leaves the step-16 snapshot with verdict
    "spike" in the manifest; an engine on that workspace serves step 8,
    the last "ok" one."""
    from singa_tpu_torch import CheckpointManager, InferenceEngine, ServeSpec
    code, text = run_main(cli_argv(conf, ws, CLI_SPIKE_STEPS, "--fault_spec",
                                   "step.grad@9:spike"), dev)
    assert code == 0, text[-3000:]
    expect_in(text, "health SPIKE at step 9")
    ck = CheckpointManager(ws, log_fn=lambda m: None)
    verdicts = {s: ck.health_verdict(s) for s in ck.available_steps()}
    assert verdicts == {CLI_CKPT: "ok", 2 * CLI_CKPT: "spike"}, verdicts
    tr = cli_trainer(conf, dev)
    net = tr.test_net or tr.train_net
    eng = InferenceEngine(net, ServeSpec(buckets=((1, 16),),
                                         max_new_tokens=4),
                          device=dev, workspace=ws, log_fn=lambda m: None)
    assert eng.load() == CLI_CKPT
    want = snapshot(ws, CLI_CKPT)[0]
    assert all(torch.equal(eng.params[k].float().cpu(), want[k])
               for k in want)
    toks = eng.run_batch("generate", np.ones((1, 16), np.int32),
                         np.array([16], np.int32))
    assert toks.shape == (1, 4)
    log(f"[cli] 12d step.grad@9:spike: manifest verdicts {verdicts}, "
        f"written by the trainer; an engine on the workspace serves step "
        f"{eng.params_step} (the last 'ok') and generates {toks.tolist()}")


def train_e(dev, conf):
    """12e: --feeder on against off at scan_chunk CLI_CHUNK on one
    trainer, in turns: equal params after each run (torch.equal), one
    capture for the geometry, tokens/s of each."""
    tr = cli_trainer(conf, dev)
    tr.cfg.train_steps = CLI_STEPS
    b = tr.train_net.layers["data"].cfg.seqdata_param
    tokens = CLI_STEPS * b.batchsize * b.seq_len
    res, ms = {}, {"on": [], "off": []}
    # a first run with the feeder captures (its thread stages meanwhile);
    # then rounds in turns
    order = ["on"] + [m for r in range(FEED_ROUNDS)
                      for m in (("off", "on") if r % 2 == 0
                                else ("on", "off"))]
    for i, mode in enumerate(order):
        p, o = tr.init(0)
        it = cli_stream(conf)
        torch.cuda.synchronize() if dev == "cuda" else None
        t0 = time.perf_counter()
        p, o, _ = tr.run(p, o, it, seed=0, scan_chunk=CLI_CHUNK,
                         feeder=(mode == "on"))
        torch.cuda.synchronize() if dev == "cuda" else None
        if i:
            ms[mode].append((time.perf_counter() - t0) * 1e3)
        it.close()
        state = ({k: v.clone() for k, v in p.items()},
                 {k: {n: t.clone() for n, t in d.items()}
                  for k, d in o.items()})
        if mode in res:
            assert state_equal(state, res[mode]), mode
        res[mode] = state
    assert state_equal(res["on"], res["off"])
    ncap = len(tr._train_graph._graphs) if tr.graphs else 0
    assert ncap == (1 if dev == "cuda" else 0), ncap
    log(f"[cli] 12e --feeder on equals off after {CLI_STEPS} steps "
        f"(torch.equal), {ncap} capture for the one geometry over "
        f"{len(order)} runs (the first, with the feeder, captures); "
        f"{CLI_STEPS}-step runs in turns ({order[1:]}): on "
        f"{[round(x, 3) for x in ms['on']]} ms, off "
        f"{[round(x, 3) for x in ms['off']]} ms; tokens/s on "
        f"{tokens / (np.mean(ms['on']) / 1e3):.1f}, off "
        f"{tokens / (np.mean(ms['off']) / 1e3):.1f}")


def train_g_health(dev, conf):
    """12g: the replayed lm.conf step with the health probes and without,
    in turns, and the drain's share of a chunk."""
    from singa_tpu_torch.utils.health import HealthMonitor
    it = cli_stream(conf)
    batches = [next(it) for _ in range(CLI_CHUNK)]
    it.close()
    stacked = {"data": {f: torch.from_numpy(np.stack(
        [b["data"][f] for b in batches])).to(dev) for f in ("input",
                                                            "target")}}
    runs, drains = {}, {"on": [], "off": []}
    for mode in ("off", "on"):
        mon = HealthMonitor(log_fn=lambda m: None) if mode == "on" else None
        tr = cli_trainer(conf, dev, health=mon)
        p, o = tr.init(0)
        state = {"p": p, "o": o, "step": 0}

        def run(tr=tr, state=state, mon=mon, mode=mode):
            for _ in range(HEALTH_STEPS // CLI_CHUNK):
                p, o, m = tr.train_steps(state["p"], state["o"], stacked,
                                         state["step"], CLI_CHUNK,
                                         stacked=True)
                state.update(p=p, o=o)
                torch.cuda.synchronize() if dev == "cuda" else None
                t0 = time.perf_counter()
                for s, mm in enumerate(tr.drain_metrics(m),
                                       start=state["step"]):
                    if mon is not None:
                        mon.observe(s, mm)
                drains[mode].append((time.perf_counter() - t0) * 1e3)
                state["step"] += CLI_CHUNK
        run()                       # captures
        drains[mode].clear()
        runs[mode] = run
    ms = in_turns(runs, HEALTH_ROUNDS)
    step = {k: np.mean(v) / HEALTH_STEPS for k, v in ms.items()}
    share = {k: np.sum(drains[k]) / np.sum(ms[k]) for k in ms}
    log(f"[cli] 12g replayed lm.conf step (chunks of {CLI_CHUNK}, "
        f"{HEALTH_ROUNDS} rounds of {HEALTH_STEPS} steps in turns): health "
        f"on {step['on']:.4f} ms, off {step['off']:.4f} ms "
        f"({100 * (step['on'] / step['off'] - 1):+.2f}%); runs on "
        f"{[round(x, 3) for x in ms['on']]} ms, off "
        f"{[round(x, 3) for x in ms['off']]} ms; the drain (one fetch of "
        f"a chunk's metrics after the device is idle, plus classifying "
        f"{CLI_CHUNK} steps) is {100 * share['on']:.2f}% of the time with "
        f"health on ({np.mean(drains['on']):.3f} ms a chunk), "
        f"{100 * share['off']:.2f}% off ({np.mean(drains['off']):.3f} ms)")


def alexnet_shard(tmp, n=ALEX_RECORDS, shape=(3, 32, 32), meanfile=False):
    """A shard folder of `n` CIFAR-shaped records (uint8 images and
    labels, numpy seed 0) written with the port's Shard, and a copy of
    examples/cifar10/alexnet.conf that reads it; with `meanfile`, the
    records' mean image as a mean record (the port's record writer)
    that the copy's kRGBImage subtracts."""
    from singa_tpu_torch.data.records import Record, SingleLabelImageRecord
    from singa_tpu_torch.data.shard import Shard
    folder = os.path.join(tmp, "cifar_shard")
    os.makedirs(folder)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    labels = rng.integers(0, 10, n)
    with Shard(folder, Shard.KCREATE) as sh:
        for i in range(n):
            sh.insert(f"{i:06d}", Record(image=SingleLabelImageRecord(
                shape=list(shape), label=int(labels[i]),
                pixel=imgs[i].tobytes())).encode())
    with open(ALEX_CONF) as f:
        text = f.read()
    assert text.count("batchsize: 1024") == 1
    text = text.replace("batchsize: 1024",
                        f'batchsize: 1024\n      path: "{folder}"')
    if meanfile:
        mean = imgs.astype(np.float64).mean(0).astype(np.float32)
        mpath = os.path.join(tmp, "cifar_mean.rec")
        with open(mpath, "wb") as f:
            f.write(Record(image=SingleLabelImageRecord(
                shape=list(shape),
                data=[float(x) for x in mean.ravel()])).encode())
        assert text.count("rgbimage_param {") == 1
        text = text.replace("rgbimage_param {",
                            f'rgbimage_param {{\n      meanfile: "{mpath}"')
    conf = os.path.join(tmp, "alexnet_shard.conf")
    with open(conf, "w") as f:
        f.write(text)
    return folder, conf


def count_captures():
    """A context in which every StepGraph capture is counted, by name."""
    import contextlib
    from singa_tpu_torch.core import step_graph

    @contextlib.contextmanager
    def ctx():
        counts: dict = {}
        real = step_graph.StepGraph._capture

        def capture(self, fn, state, batch):
            counts[self.name] = counts.get(self.name, 0) + 1
            return real(self, fn, state, batch)
        step_graph.StepGraph._capture = capture
        try:
            yield counts
        finally:
            step_graph.StepGraph._capture = real
    return ctx()


def train_f(dev, tmp, expect_launches, n=ALEX_RECORDS, batch=None,
            meanfile=False, tag="12f"):
    """12f: AlexNet-CIFAR10 from a shard folder through the CLI: the
    discovered geometry is the shard's, K5 and K6 launch 2 + 2 a step
    from the replays of one captured train step, and the loss is
    finite.  With `meanfile` (13d), its kRGBImage subtracts a mean
    record."""
    from singa_tpu_torch import load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    from singa_tpu_torch.data.discovery import _peek_shard
    from singa_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    folder, conf = alexnet_shard(tmp, n, meanfile=meanfile)
    t_write = time.perf_counter() - t0
    assert _peek_shard(folder) == (3, 32, 32)
    shapes = discover_input_shapes(load_model_config(conf))
    assert shapes["data"]["pixel"] == (3, 32, 32), shapes
    argv = ["-model_conf", conf, "--steps", str(ALEX_CLI_STEPS)]
    if batch:
        argv += ["--batchsize", str(batch)]
    torch.cuda.synchronize() if dev == "cuda" else None
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with count_captures() as caps:
        code, text = run_main(argv, dev)
    torch.cuda.synchronize() if dev == "cuda" else None
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    assert code == 0, text[-3000:]
    done = [ln for ln in text.splitlines() if "training done" in ln][-1]
    loss = float(re.search(r"loss : ([-+0-9.einfa]+)", done).group(1))
    assert math.isfinite(loss), done
    if expect_launches:
        want = {k: 0 for k in launches}
        want.update(lrn_fwd=2 * ALEX_CLI_STEPS, lrn_bwd=2 * ALEX_CLI_STEPS)
        assert launches == want, launches
        assert caps == {"train_step": 1}, caps
    log(f"[cli] {tag} AlexNet-CIFAR10 (examples/cifar10/alexnet.conf, batch "
        f"{batch or 1024}{', a meanfile' if meanfile else ''}) from a "
        f"shard folder of {n} records written in {t_write:.3f} s: "
        f"discovery peeked {shapes['data']['pixel']}; {ALEX_CLI_STEPS} CLI "
        f"steps in {wall:.3f} s wall (net build, data, capture, replays); "
        f"captures {caps}; launches {launches}; mean loss {loss:.6f}")
    return launches


def phase_cli(dev, conf=None, expect_launches=True, alex=None):
    """Phase 12: training as users run it — the CLI with the Supervisor,
    the health tier, the fault sites and the data pipeline.  `conf`
    (lm.conf by default) and `alex` ((records, batch) for 12f) cut it
    down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli-", dir=os.path.join(REPO, "build"))
    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] phase 12{what}: {now - clock[0]:.1f} s")
        clock[0] = now
    try:
        conf = cli_conf(tmp, conf)
        ws = {k: os.path.join(tmp, k) for k in ("a", "b", "ref", "c", "d")}
        launches = train_a(dev, conf, ws["a"], expect_launches)
        took("a")
        train_b(dev, conf, ws["b"], ws["ref"], ws["a"])
        took("b")
        train_c(dev, conf, ws["c"])
        took("c")
        train_d(dev, conf, ws["d"])
        took("d")
        train_e(dev, conf)
        took("e")
        launches.update({k: v for k, v in train_f(
            dev, tmp, expect_launches, *(alex or ())).items()
            if k in ("lrn_fwd", "lrn_bwd")})
        took("f")
        train_g_health(dev, conf)
        took("g")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache() if dev == "cuda" else None


# -- phase 13: the vision steps as the reference compiles them ------------
VR_STEPS, VR_CADENCE = 8, 4     # 13a: the run, its checkpoint cadence
VR_CROP = 28                    # 13a: the copy's cropsize (records of 32)
MNIST_CONF = os.path.join(REPO, "examples", "mnist", "conv.conf")
MNIST_SHAPES = {"data": {"pixel": (28, 28), "label": ()}}
DISTORT = ("norm_a: 255.0 kernel: 5 sigma: 6.0 alpha: 8.0 beta: 15.0 "
           "gamma: 15.0 elastic_freq: 4")
DISTORT_STEPS = 12
# 13b: the warp on the card against the CPU, on images in [0, 1): f32
# formulas alike, sin, cos and the blur's sums rounded by other libraries
WARP_ATOL = 1e-5
RBM_CONF = os.path.join(REPO, "examples", "mnist", "rbm.conf")
RBM_STEPS = 200


def conf_copy(tmp, src, name, subs):
    """A copy of config `src` with each (old, new) of `subs` replaced
    once."""
    with open(src) as f:
        text = f.read()
    for old, new in subs:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def vision_resume(dev, tmp, batch):
    """13a: AlexNet-CIFAR10 with a random crop of VR_CROP (a copy of
    alexnet.conf), captured: a run of VR_STEPS steps saving every
    VR_CADENCE, and another captured trainer that restores the middle
    snapshot and trains the rest, must end equal under torch.equal; the
    crop's gather and the mirror replay as eager forwards draw them."""
    from singa_tpu_torch import (CheckpointManager, Trainer,
                                 load_model_config, numpy_params,
                                 params_from_numpy, synthetic_image_batches)
    from singa_tpu_torch.weights import opt_state_from_numpy
    conf = conf_copy(tmp, ALEX_CONF, "alexnet_crop.conf", [
        ("rgbimage_param {", f"rgbimage_param {{\n      cropsize: {VR_CROP}"),
        ("batchsize: 1024", f"batchsize: {batch}")])

    def trainer():
        cfg = load_model_config(conf)
        cfg.precision = "bfloat16"
        cfg.train_steps = VR_STEPS
        cfg.checkpoint_frequency = VR_CADENCE
        return Trainer(cfg, RGB_SHAPES, device=dev, log_fn=lambda m: None)
    tr = trainer()
    data = synthetic_image_batches(batch, (3, 32, 32), seed=5,
                                   stream_seed=6)
    batches = [next(data) for _ in range(VR_STEPS)]
    ws = os.path.join(tmp, "alex_ws")
    p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, 1),
                          device=dev)
    t0 = time.perf_counter()
    p, o, _ = tr.run(p, tr.updater.init(p), iter(batches), workspace=ws)
    torch.cuda.synchronize() if dev == "cuda" else None
    wall = time.perf_counter() - t0
    mgr = CheckpointManager(ws, log_fn=lambda m: None)
    assert mgr.available_steps() == list(range(VR_CADENCE, VR_STEPS + 1,
                                               VR_CADENCE)), \
        mgr.available_steps()
    rp, ro, step = mgr.restore(VR_CADENCE)
    tr2 = trainer()
    p2 = params_from_numpy(tr2.train_net, rp, device=dev)
    o2 = opt_state_from_numpy(tr2.train_net, ro, device=dev)
    p2, o2, _ = tr2.run(p2, o2, iter(batches[step:]), start_step=step)
    equal = state_equal((p, o), (p2, o2))
    log(f"[vision] 13a AlexNet-CIFAR10 crop {VR_CROP} + mirror + dropout, "
        f"b={batch} bf16, graphs {tr.graphs}/{tr2.graphs}: {VR_STEPS} steps "
        f"saving every {VR_CADENCE} in {wall:.3f} s, resumed from step "
        f"{step} in another captured trainer: params and momentum equal "
        f"the uninterrupted run's under torch.equal: {equal}")
    assert equal
    if dev == "cuda":
        alexnet_draws(tr2, batches[0])


def distort_warp_card(dev):
    """13b: elastic_warp on the card against the CPU on the same images
    and draws (batch 64, the k5 field, rotation and scale)."""
    from singa_tpu_torch.ops import augment
    x = torch.from_numpy(np.random.default_rng(4).random((64, 28, 28))
                         .astype(np.float32))
    draws = augment.elastic_draws(64, 28, 28,
                                  torch.Generator().manual_seed(4), x.device,
                                  kernel=5, alpha=8.0, beta=15.0, gamma=15.0)
    kw = dict(kernel=5, sigma=6.0, alpha=8.0)
    cpu = augment.elastic_warp(x, *draws, **kw)
    card = augment.elastic_warp(x.to(dev), *(d.to(dev) for d in draws),
                                **kw).cpu()
    gap = (card - cpu).abs().max().item()
    moved = (cpu - x).abs().max().item()
    log(f"[vision] 13b elastic_warp card against CPU (64x28x28 in [0, 1), "
        f"k5 sigma 6 alpha 8, beta 15, gamma 15): max gap {gap:.3g} (atol "
        f"{WARP_ATOL}); the warp moves pixels by up to {moved:.3f}")
    assert gap <= WARP_ATOL and moved > 0.1, (gap, moved)


def distort_runs(dev, conf, deterministic):
    """DISTORT_STEPS steps of the distorting LeNet, captured and eager,
    from one start, with cuDNN's `deterministic` flag as given: {mode:
    (trainer, params, opt, ms per step, MiB allocated after each)}."""
    from singa_tpu_torch import (Trainer, load_model_config, numpy_params,
                                 params_from_numpy, synthetic_image_batches)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    runs = {}
    try:
        for mode, graphs in (("graph", None), ("eager", False)):
            tr = Trainer(load_model_config(conf), MNIST_SHAPES, device=dev,
                         graphs=graphs, log_fn=lambda m: None)
            p = params_from_numpy(tr.train_net,
                                  numpy_params(tr.train_net, 2), device=dev)
            o = tr.updater.init(p)
            data = synthetic_image_batches(64, (28, 28), seed=7,
                                           stream_seed=8)
            ms, mem = [], []
            for step in range(DISTORT_STEPS):
                torch.cuda.synchronize() if dev == "cuda" else None
                t0 = time.perf_counter()
                p, o, m = tr.train_step(p, o, next(data), step)
                float(m["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
                mem.append(torch.cuda.memory_allocated() / 2 ** 20
                           if dev == "cuda" else 0.0)
            runs[mode] = (tr, p, o, ms, mem)
    finally:
        torch.cuda.synchronize() if dev == "cuda" else None
        torch.backends.cudnn.deterministic = prev
    return runs


def vision_distort(dev, tmp):
    """13b: LeNet (a copy of examples/mnist/conv.conf) with the elastic
    distortion every 4th step, batch 64, captured (two graphs: the
    distorting and the plain steps) and eager from one start.  With
    cuDNN's deterministic algorithms the DISTORT_STEPS steps must leave
    params and momentum equal under torch.equal; with its defaults
    (what the trainer runs) the gap, the first call of each graph
    (warm-up and capture) against a replay, and the kernels a replayed
    and an eager distorting step run are printed."""
    conf = conf_copy(tmp, MNIST_CONF, "conv_distort.conf",
                     [("norm_a: 255.0", DISTORT)])
    det = distort_runs(dev, conf, True)
    equal = state_equal(det["graph"][1:3], det["eager"][1:3])
    log(f"[vision] 13b LeNet + distortion (elastic_freq 4), b=64, cuDNN "
        f"deterministic: {DISTORT_STEPS} replayed steps equal "
        f"{DISTORT_STEPS} eager ones under torch.equal: {equal}")
    assert equal
    runs = distort_runs(dev, conf, False)
    tr, p, o, ms, mem = runs["graph"]
    etr, ep, eo, ems, _ = runs["eager"]
    gap = max((p[k].float() - ep[k].float()).abs().max().item() for k in p)
    ncap = len(tr._train_graph._graphs) if tr.graphs else 0
    steady = [ms[i] for i in range(2, DISTORT_STEPS)]
    log(f"[vision] 13b cuDNN defaults: {DISTORT_STEPS} replayed steps over "
        f"{ncap} graphs against eager ones: largest param gap {gap:.3g} "
        f"(equal: {gap == 0}); step 0 (distorting: warm-up and capture) "
        f"{ms[0]:.1f} ms, step 1 (plain: the second capture) {ms[1]:.1f} "
        f"ms, replays {min(steady):.3f}-{max(steady):.3f} ms (distorting "
        f"steps {[round(ms[i], 3) for i in (4, 8)]}); eager steps "
        f"{min(ems[2:]):.3f}-{max(ems[2:]):.3f} ms; allocated after step 0 "
        f"{mem[0]:.1f} MiB, after step 1 {mem[1]:.1f} MiB")
    if dev == "cuda":
        assert ncap == 2, ncap
        from singa_tpu_torch import synthetic_image_batches
        batch = next(synthetic_image_batches(64, (28, 28), seed=9))
        names = {}
        for mode, t, pp, oo, wall in (("graph", tr, p, o, min(steady)),
                                      ("eager", etr, ep, eo, min(ems[2:]))):
            # step DISTORT_STEPS (a multiple of 4) distorts
            prof = profile(f"lenet_distort_step_{mode}", lambda: t.train_step(
                pp, oo, batch, DISTORT_STEPS), wall, top=6)
            names[mode] = set(prof["counts"])
        only = {m: sorted(n[:80] for n in names[m] - names[o_])
                for m, o_ in (("graph", "eager"), ("eager", "graph"))}
        log(f"[vision] 13b kernels only in the replayed distorting step: "
            f"{only['graph']}; only in the eager one: {only['eager']}")
        distort_warp_card(dev)


def rbm_cli(dev, tmp):
    """13c: the CLI (`main(argv)` in this process) on
    examples/mnist/rbm.conf `--synthetic --steps RBM_STEPS` exits 0;
    then rbm.conf with rbm1 persistent (PCD): the captured CD steps (one
    graph per RBM) must equal eager ones under torch.equal, and recon
    must fall in each phase."""
    from singa_tpu_torch import Trainer, load_model_config
    from singa_tpu_torch.data import discover_input_shapes, resolve_data_source
    t0 = time.perf_counter()
    code, text, launches = run_main_launches(
        ["-model_conf", RBM_CONF, "--synthetic", "--steps",
         str(RBM_STEPS)], dev)
    wall = time.perf_counter() - t0
    assert code == 0, text[-3000:]
    lines = [ln.split("] ", 1)[-1] for ln in text.splitlines()
             if " cd[" in ln or "training done" in ln]
    log(f"[vision] 13c rbm.conf CLI (main(argv) in this process), "
        f"{RBM_STEPS} steps: exit {code} in {wall:.3f} s wall; {lines}; "
        f"launches {launches}")
    assert any("cd[rbm0]" in ln for ln in lines) and \
        any("cd[rbm1]" in ln for ln in lines), lines
    runs = {}
    for mode, graphs in (("graph", None), ("eager", False)):
        cfg = load_model_config(RBM_CONF)
        cfg.train_steps = RBM_STEPS
        cfg.neuralnet.layer[3].rbm_param.persistent = True
        shapes = discover_input_shapes(cfg, force_synthetic=True)
        tr = Trainer(cfg, shapes, device=dev, graphs=graphs,
                     log_fn=lambda m: None)
        p, o = tr.init(seed=0)
        it, _ = resolve_data_source(cfg, 64, seed=0, force_synthetic=True,
                                    sample_shapes=shapes)
        recon, stamps = [], []

        def hook(step, m):
            recon.append(m["recon"])
            stamps.append(time.perf_counter())
        torch.cuda.synchronize() if dev == "cuda" else None
        t0 = time.perf_counter()
        try:
            p, o, _ = tr.run(p, o, it, seed=0, hooks=[hook])
        finally:
            it.close()
        # a step's host time between hooks (each after the step's fetch),
        # the median over the steady steps of each phase
        gaps = np.diff(stamps) * 1e3
        runs[mode] = (tr, p, o, recon, time.perf_counter() - t0,
                      float(np.median(np.concatenate(
                          [gaps[5:RBM_STEPS // 2 - 1],
                           gaps[RBM_STEPS // 2 + 5:]]))))
    tr, p, o, recon, wall, step_ms = runs["graph"]
    _, ep, eo, erecon, ewall, estep_ms = runs["eager"]
    equal = state_equal((p, o), (ep, eo)) and recon == erecon
    ncap = len(tr._cd_graph._graphs) if tr.graphs else 0
    half = RBM_STEPS // 2
    phases = [(float(np.mean(recon[a:a + 10])),
               float(np.mean(recon[b - 10:b])))
              for a, b in ((0, half), (half, RBM_STEPS))]
    log(f"[vision] 13c rbm.conf (rbm1 persistent), b=64: {RBM_STEPS} CD "
        f"steps replayed over {ncap} graphs in {wall:.3f} s (captures "
        f"included), eager {ewall:.3f} s; a steady step (median, a fetch "
        f"each) {step_ms:.4f} ms replayed, {estep_ms:.4f} ms eager; "
        f"params, momentum and every "
        f"recon equal under torch.equal: {equal}; recon (mean of the "
        f"first and last 10 steps) rbm0 {phases[0][0]:.5f} -> "
        f"{phases[0][1]:.5f}, rbm1 {phases[1][0]:.5f} -> "
        f"{phases[1][1]:.5f}")
    assert equal
    assert all(last < first for first, last in phases), phases
    if dev == "cuda":
        assert ncap == 2, ncap


def phase_vision(dev, alex_batch=ALEX_BATCH, records=ALEX_RECORDS,
                 cli_batch=None):
    """Phase 13: the vision steps as the reference compiles them.  The
    arguments cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="vision-", dir=os.path.join(REPO, "build"))
    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] phase 13{what}: {now - clock[0]:.1f} s")
        clock[0] = now
    try:
        vision_resume(dev, tmp, alex_batch)
        took("a")
        vision_distort(dev, tmp)
        took("b")
        rbm_cli(dev, tmp)
        took("c")
        launches = train_f(dev, tmp, dev == "cuda", records, cli_batch,
                           meanfile=True, tag="13d")
        took("d")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache() if dev == "cuda" else None


# ---------------------------------------------------------------------------
# phase 14: measuring the card as the reference measures the TPU

# the phase each kernel library's device time must fall under in a
# profiled step (K2's merge kernel is part of K2)
KERNEL_PHASE = {"flash_fwd": "fwd", "head_fwd": "fwd", "flash_dq": "bwd",
                "flash_dkv": "bwd", "lrn_fwd": "fwd", "lrn_bwd": "bwd"}
MEASURE_STEPS = 2       # steps of each twin before the profile
CLI_PROFILE_STEPS = 16
DEBUG_STEPS = 4
# debug norms card against CPU: relative, and the .6f print's resolution
DEBUG_RTOL, DEBUG_ATOL = 1e-4, 1e-6
MEASURED_PROGRAMS = ("cb_prefill", "cb_decode", "predict", "train_step")


def kernel_lib(name: str):
    """The kernel library (K1-K6) that a device kernel's name belongs
    to, or None for any other kernel."""
    m = re.search(r"\b(flash_fwd|flash_dq|flash_dkv|head_fwd|head_merge|"
                  r"lrn_fwd|lrn_bwd)\w*_kernel\b", name)
    if m is None:
        return None
    return "head_fwd" if m.group(1) == "head_merge" else m.group(1)


def lm_shapes(lm_kw):
    return {"data": {"input": (lm_kw["seq_len"],),
                     "target": (lm_kw["seq_len"],)}}


def alex_config(batch):
    from singa_tpu_torch import load_model_config
    cfg = load_model_config(ALEX_CONF)
    cfg.test_steps = 0
    for layer in cfg.neuralnet.layer:
        if layer.data_param:
            layer.data_param.batchsize = batch
    return cfg


def measure_flops(lm_kw, alex_batch):
    """(a) Analytic train-step FLOPs of the bench stack, lm.conf and
    AlexNet-CIFAR10, and the MFU of phases 7, 9 and 10's replayed steps
    on the card's bf16 peak."""
    from singa_tpu_torch import build_net, load_model_config, transformer_lm
    from singa_tpu_torch.utils.flops import (mfu, net_forward_flops,
                                             net_train_flops, peak_flops)
    peak = peak_flops(0) if torch.cuda.is_available() else None
    nets = {
        "bench": build_net(transformer_lm(**lm_kw, precision="bfloat16"),
                           "kTrain", lm_shapes(lm_kw)),
        "lmconf": build_net(load_model_config(LM_CONF), "kTrain",
                            LM_SHAPES),
        "alexnet": build_net(alex_config(alex_batch), "kTrain", RGB_SHAPES),
    }
    where = {"bench": "phase 7", "lmconf": "phase 10 (b)",
             "alexnet": "phase 9"}
    out = {}
    for name, net in nets.items():
        fwd, train = net_forward_flops(net), net_train_flops(net)
        got = MEASURED.get(name)
        if got is None or peak is None:
            log(f"[measure] (a) {name}: forward {fwd} FLOPs, train step "
                f"{train} FLOPs (analytic); MFU not measured in this run")
            continue
        ms = got["ms"]
        out[name] = mfu(train, ms / 1e3, 0)
        log(f"[measure] (a) {name}: forward {fwd} FLOPs, train step "
            f"{train} FLOPs (analytic, 2·MACs, 3x the forward); "
            f"{where[name]}'s replayed step {ms:.4f} ms -> "
            f"{train / ms / 1e9:.1f} TFLOP/s, MFU {out[name]:.4f} of the "
            f"{peak / 1e12:.0f} TFLOP/s bf16 peak")
    return out


def profiled_twins(tag, make, batches, want, dev):
    """(b) Two trainers from one start take MEASURE_STEPS steps each
    (replays on the card); `Trainer.profile_phases` traces one eager step
    of the first on clones; then one more step of each must leave the two
    equal under torch.equal.  On the card the profile must launch `want`
    and put each of K1-K6's device time under its phase."""
    from singa_tpu_torch.ops import _kernels
    (tr, p, o), (tw, q, r) = make(), make()
    for i in range(MEASURE_STEPS):
        p, o, _ = tr.train_step(p, o, batches[i], i)
        q, r, _ = tw.train_step(q, r, batches[i], i)
    n = MEASURE_STEPS
    before = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    shares = tr.profile_phases(p, o, batches[n], step=n)
    prof_s = time.perf_counter() - t0
    delta = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
    by_lib: dict = {}
    for (ph, name), us in tr.phase_kernels.items():
        lib = kernel_lib(name)
        if lib is not None:
            by_lib.setdefault(lib, {})
            by_lib[lib][ph] = by_lib[lib].get(ph, 0.0) + us / 1e3
    attributed = sum(us for (ph, _), us in tr.phase_kernels.items()
                     if ph is not None) / 1e3
    p, o, _ = tr.train_step(p, o, batches[n], n)
    q, r, _ = tw.train_step(q, r, batches[n], n)
    equal = state_equal((p, o), (q, r))
    log(f"[measure] (b) {tag}: profile_phases (one eager step on clones, "
        f"traced, {prof_s:.3f} s with the trace's export): fwd "
        f"{shares['fwd']:.4f}, bwd {shares['bwd']:.4f}, update "
        f"{shares['update']:.4f} of {attributed:.3f} ms attributed, "
        f"coverage {shares['coverage']:.4f}; launches {delta}; K1-K6 device "
        f"ms by phase "
        + json.dumps({k: {str(ph): round(v, 4) for ph, v in d.items()}
                      for k, d in sorted(by_lib.items())})
        + f"; the next step of the profiled trainer equals an unprofiled "
        f"twin's under torch.equal: {equal}")
    split = MEASURED.get(tag, {}).get("split")
    if split is not None:
        tot = sum(split)
        log(f"[measure] (b) {tag}: beside it, the CUDA-event split of an "
            f"eager step from its phase: forward {split[0]:.3f} ms "
            f"({split[0] / tot:.4f}), backward {split[1]:.3f} ms "
            f"({split[1] / tot:.4f}), update {split[2]:.3f} ms "
            f"({split[2] / tot:.4f})")
    assert equal, tag
    assert abs(shares["fwd"] + shares["bwd"] + shares["update"] - 1) < 1e-9
    assert 0 < shares["fwd"] < 1 and 0 < shares["bwd"] < 1, shares
    assert "[device: fwd" in tr.timer.to_string()
    if dev == "cuda":
        assert delta == want, (tag, delta, want)
        for lib, launched in want.items():
            got = by_lib.get(lib, {})
            if launched:
                assert set(got) == {KERNEL_PHASE[lib]}, (tag, lib, got)
            else:
                assert not got, (tag, lib, got)
    return shares


def measure_split(dev, arrays, lm_kw, alex_batch):
    """(b) the bench stack and AlexNet-CIFAR10, profiled twins, with
    cuDNN's deterministic algorithms: with its defaults two captured
    AlexNet trainers from one start part by ~1e-8 after one step, as
    13b's LeNet does (an atomics-summed weight gradient)."""
    torch.backends.cudnn.deterministic = True
    try:
        twins(dev, arrays, lm_kw, alex_batch)
    finally:
        torch.backends.cudnn.deterministic = False


def twins(dev, arrays, lm_kw, alex_batch):
    from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                                 synthetic_image_batches,
                                 synthetic_token_batches, transformer_lm)
    none = {k: 0 for k in KERNEL_PHASE}
    layers = lm_kw["num_layers"]

    def make_lm():
        cfg = transformer_lm(**lm_kw, precision="bfloat16")
        cfg.test_steps = 0
        tr = Trainer(cfg, lm_shapes(lm_kw), device=dev, log_fn=trainer_log)
        return (tr, *start(tr, arrays, dev))
    data = synthetic_token_batches(lm_kw["batchsize"], lm_kw["seq_len"],
                                   lm_kw["vocab_size"], seed=29)
    profiled_twins("bench", make_lm,
                   [next(data) for _ in range(MEASURE_STEPS + 1)],
                   {**none, "flash_fwd": layers, "head_fwd": 1,
                    "flash_dq": layers, "flash_dkv": layers}, dev)

    def make_alex():
        tr = Trainer(alex_config(alex_batch), RGB_SHAPES, device=dev,
                     log_fn=trainer_log)
        p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, 0),
                              device=dev)
        return tr, p, tr.updater.init(p)
    data = synthetic_image_batches(alex_batch, (3, 32, 32), seed=0,
                                   stream_seed=31)
    profiled_twins("alexnet", make_alex,
                   [next(data) for _ in range(MEASURE_STEPS + 1)],
                   {**none, "lrn_fwd": 2, "lrn_bwd": 2}, dev)


def measure_cli(dev, conf):
    """(c) the CLI with `--phase_profile` (`main(argv)` in this process):
    exit 0, and its Time per step lines carry the split."""
    argv = ["-model_conf", conf, "--synthetic", "--steps",
            str(CLI_PROFILE_STEPS), "--phase_profile"]
    t0 = time.perf_counter()
    code, text = run_main(argv, dev)
    wall = time.perf_counter() - t0
    if code != 0:
        print(text[-8000:], file=sys.stderr)
    assert code == 0, code
    lines = [line for line in text.splitlines() if "Time per step" in line]
    assert lines and all("[device: fwd" in line for line in lines), lines
    log(f"[measure] (c) main(['-model_conf', "
        f"'{os.path.relpath(conf, REPO)}', '--synthetic', '--steps', "
        f"'{CLI_PROFILE_STEPS}', '--phase_profile']) in this process: exit "
        f"0 in {wall:.3f} s wall; "
        f"{lines[0].split('] ', 1)[-1]}")


def measure_convergence(dev, tmp, **kw):
    """(d) convergence_run on conv.conf: 99% on the card, its
    time-to-99 written to a temporary file."""
    from singa_tpu_torch.tools import convergence_run
    out = os.path.join(tmp, "CONVERGENCE.json")
    res = convergence_run.run(MNIST_CONF, out=out, device=dev,
                              log=lambda s: None, **kw)
    with open(out) as f:
        assert json.load(f) == res
    log(f"[measure] (d) tools.convergence_run on examples/mnist/conv.conf: "
        + json.dumps(res))
    if dev == "cuda":
        assert res["reached"], res
        assert res["device"] == torch.cuda.get_device_name(0), res
    return res


def measure_costs(dev, lm_steps=4):
    """(e) CostWatch: a cb=on engine's warm-up on lm.conf in f32 counts
    each program; `harvest_costs()` captures nothing; after traffic and
    `Trainer.run` steps, `obs.perf` reports FLOPs and MFU for every warm
    program and the train step."""
    from singa_tpu_torch import (InferenceEngine, ServeSpec, build_net,
                                 load_model_config, numpy_params,
                                 params_from_numpy)
    from singa_tpu_torch.obs import perf
    from singa_tpu_torch.serve import ContinuousScheduler
    watch = perf.reset()
    net = build_net(load_model_config(LM_CONF), "kTest", LM_SHAPES)
    params = params_from_numpy(net, numpy_params(net, seed=0), device=dev)
    spec = ServeSpec(**{**CB_SPEC, **LM_CB}, buckets=((8, 128),))
    eng = InferenceEngine(net, spec, params, device=dev, log_fn=log)
    n = eng.warmup(("generate", "predict"))
    compiles = eng.stats.compiles
    harvested = eng.harvest_costs()
    assert eng.stats.compiles == compiles, (compiles, eng.stats.compiles)
    rng = np.random.default_rng(23)
    sched = ContinuousScheduler(eng, log_fn=log)
    tickets = [sched.submit(rng.integers(0, 4096, k).astype(np.int32),
                            max_new=16) for k in (40, 100, 200, 17)]
    sched.start()
    try:
        outs = [t.wait(300.0) for t in tickets]
    finally:
        sched.stop()
    assert all(len(o["tokens"]) == 16 for o in outs), outs
    eng.answer("predict", [list(rng.integers(0, 4096, 128))
                           for _ in range(8)])
    assert eng.harvest_costs() == harvested
    assert eng.stats.compiles == compiles, (compiles, eng.stats.compiles)
    tr = lm_trainer(dev, None)
    tr.cfg.train_steps = lm_steps
    p, o = tr.init(0)
    tr.run(p, o, iter(lm_batches(lm_steps, seed=5)))
    got = {}
    for smp in watch.collect():
        if smp.name in ("singa_program_flops", "singa_program_mfu"):
            got.setdefault(dict(smp.labels)["program"], {})[smp.name] = \
                smp.value
    cost = watch.snapshot()["cost"]
    log(f"[measure] (e) cb=on engine on lm.conf (f32): warm-up captured "
        f"{n}, harvest_costs() re-recorded {harvested} programs, captures "
        f"{compiles} before and after; obs.perf: "
        + json.dumps({k: {**{m.replace('singa_program_', ''): v
                             for m, v in d.items()},
                          "step_ms": (round(cost[k]["seconds"] * 1e3
                                            / cost[k]["calls"], 4)
                                      if cost[k].get("calls") else None)}
                      for k, d in sorted(got.items())}))
    want = ("singa_program_flops", "singa_program_mfu") if dev == "cuda" \
        else ("singa_program_flops",)
    for program in MEASURED_PROGRAMS:
        assert all(m in got.get(program, {}) for m in want), (program, got)
    perf.reset()


def debug_blocks(logs):
    """step -> {name: [values]} from a run's `step-N debug:` log
    entries."""
    out = {}
    for entry in logs:
        m = re.match(r"step-(\d+) debug:\n", entry)
        if not m:
            continue
        rows = {}
        for line in entry.splitlines()[1:]:
            name, rest = line.split(": ", 1)
            rows[name] = [float(x) for x in rest.split()[1::2]]
        out[int(m.group(1))] = rows
    return out


def measure_debug(dev, tmp):
    """(f) conv.conf with `debug: true` trains DEBUG_STEPS steps on the
    card: its debug lines name every layer and param and agree with the
    same steps on the CPU."""
    from singa_tpu_torch import (Trainer, load_model_config, numpy_params,
                                 params_from_numpy, synthetic_image_batches)
    conf = conf_copy(tmp, MNIST_CONF, "conv_debug.conf",
                     [("display_frequency: 100",
                       "display_frequency: 2\ndebug: true")])
    blocks = {}
    for d in (dev, "cpu"):
        logs = []
        cfg = load_model_config(conf)
        cfg.train_steps = DEBUG_STEPS
        tr = Trainer(cfg, MNIST_SHAPES, device=d, log_fn=logs.append)
        p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, 0),
                              device=d)
        tr.run(p, tr.updater.init(p),
               synthetic_image_batches(64, seed=2, stream_seed=3))
        blocks[d] = debug_blocks(logs)
    net = tr.train_net
    names = set(net.param_specs) | {
        n for n in net.topo
        if net.layers[n].cfg.type not in ("kShardData", "kLabel",
                                          "kSoftmaxLoss")}
    card, cpu = blocks[dev], blocks["cpu"]
    assert sorted(card) == sorted(cpu) == [0, 2], (sorted(card), sorted(cpu))
    worst = 0.0
    for step in card:
        assert set(card[step]) == set(cpu[step]) == names, \
            (step, set(card[step]) ^ names)
        for name, vals in card[step].items():
            for a, b in zip(vals, cpu[step][name]):
                assert abs(a - b) <= DEBUG_RTOL * abs(b) + DEBUG_ATOL, \
                    (step, name, a, b)
                if b:
                    worst = max(worst, abs(a - b) / abs(b))
    log(f"[measure] (f) conv.conf with debug: true, {DEBUG_STEPS} steps on "
        f"{dev} and on the CPU: debug lines at steps {sorted(card)} name "
        f"all {len(names)} layers and params; largest relative gap "
        f"{worst:.3g} (within {DEBUG_RTOL} relative + {DEBUG_ATOL}); e.g. "
        f"step 2 ip2/weight {card[2]['ip2/weight']}")


def phase_measure(dev, arrays, lm_kw=BENCH, alex_batch=ALEX_BATCH,
                  cli_conf=LM_CONF, convergence=None):
    """Phase 14: FLOPs and MFU, the phase split on the card, the CLI's
    --phase_profile, time-to-99, CostWatch and ModelProto.debug.  The
    arguments cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="measure-",
                           dir=os.path.join(REPO, "build"))
    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] phase 14{what}: {now - clock[0]:.1f} s")
        clock[0] = now
    try:
        mfus = measure_flops(lm_kw, alex_batch)
        took("a")
        measure_split(dev, arrays, lm_kw, alex_batch)
        took("b")
        measure_cli(dev, cli_conf)
        took("c")
        measure_convergence(dev, tmp, **(convergence or {}))
        took("d")
        measure_costs(dev)
        took("e")
        measure_debug(dev, tmp)
        took("f")
        return mfus
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache() if dev == "cuda" else None


# ---------------------------------------------------------------------------
# phase 15: the serving control plane on the card — a fleet behind the
# Router, rollout, failover, the autoscaler, worker processes and the CLI

# a resume leg re-admits prompt ‖ emitted prefix: the cap leaves room
FLEET_SPEC = dict(buckets=((1, 16),), max_new_tokens=128, cb="on",
                  cb_slots=8, cb_block_len=16, cb_prompt_cap=256,
                  queue_capacity=128, request_timeout_s=300.0)
FLEET_N = 32            # 15a's greedy requests, prompts of 16-128 tokens
FLEET_STREAMS = 3       # 15c's concurrent streams, 128 tokens each
FLEET_WAIT = 300.0      # every wait of this phase is bounded
# allocated bytes that a grow and its retire may leave behind (cuBLAS's
# per-stream workspaces are released before each reading): far below
# one engine of either stack, so a retired engine that stays referenced
# fails the check
MEM_SLACK = 16 << 20
SCALE_SPEC = dict(buckets=((1, 16),), max_new_tokens=32, cb="on",
                  cb_slots=8, cb_block_len=16, cb_prompt_cap=64,
                  queue_capacity=256, request_timeout_s=120.0)
# 15d's traffic: a ramp, a flash crowd over one engine's capacity, quiet
SCALE_LOAD = dict(ramp=(1.5, 20.0, 200.0), flash=(2.0, 200.0, 4.0),
                  quiet=(4.0, 2.0))
PROC_SPEC = ("buckets=1x16,max_new_tokens=128,cb=on,cb_slots=8,"
             "cb_block_len=16,cb_prompt_cap=256,request_timeout_s=120")
# the CLI on the CPU for a rehearsal (`python -m` runs it on the card)
CPU_MAIN = ("import sys; from singa_tpu_torch.main import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")


def main_cmd(dev):
    """The command line of `python -m singa_tpu_torch.main` on `dev`."""
    return ([sys.executable, "-m", "singa_tpu_torch.main"] if dev == "cuda"
            else [sys.executable, "-c", CPU_MAIN])


def allocated(dev):
    """Device bytes allocated, after a garbage collection, with cuBLAS's
    per-stream workspaces released (each capture's side stream gets
    one; they are a cache of the library, not an engine's)."""
    import gc
    gc.collect()
    if dev != "cuda":
        return 0
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def fleet_traffic(vocab, n=FLEET_N, seed=15, cap=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).astype(np.int32)
            for k in rng.integers(16, cap + 1, n)]


def tie_rule(net, params, dev, prompt, got, want, tag):
    """None when `got` equals `want`, else (index, top-2 gap) of the first
    differing token, which must sit at a gap below NEAR_TIE (phase 4b's
    rule: decode batches of another size round differently)."""
    got, want = list(got), list(want)
    assert len(got) == len(want), (tag, len(got), len(want))
    if got == want:
        return None
    i, gap = first_divergence(net, params, dev, prompt, got, want)
    assert gap < NEAR_TIE, (tag, i, gap)
    return i, gap


def fleet_reference(net, params, dev, spec, prompts):
    """Each prompt's answer from one replayed engine's scheduler (all
    submitted before it starts)."""
    from singa_tpu_torch.serve import ContinuousScheduler, InferenceEngine
    eng = InferenceEngine(net, spec, params, device=dev, log_fn=log)
    sched = ContinuousScheduler(eng, log_fn=log)
    tickets = [sched.submit(p) for p in prompts]
    sched.start()
    try:
        return [t.wait(FLEET_WAIT)["tokens"] for t in tickets]
    finally:
        sched.stop()


def concurrently(fn, items, workers=None):
    """`fn` over `items` in threads; results in order, exceptions
    raised."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(workers or len(items)) as ex:
        return list(ex.map(fn, items))


def fleet_steps(fleet):
    return {n: fleet.router.handle_for(n).engine.params_step
            for n in fleet.router.names()}


def fleet_a(dev, net, params, fleet, prompts, want):
    """15a: answers through the router (a grow captures meanwhile),
    retire and memory, router overhead, fleet against one engine."""
    from singa_tpu_torch.obs import perf
    from singa_tpu_torch.serve import LocalEngineHandle
    handles = {h.name: h for h in fleet._local}
    compiles = {n: h.engine.stats.compiles for n, h in handles.items()}
    anomalies = perf.snapshot()["anomalies"]
    before_grow = allocated(dev)
    grown = {}

    def grow():
        t0 = time.perf_counter()
        grown["name"] = fleet.grow()
        grown["s"] = time.perf_counter() - t0

    import threading
    t = threading.Thread(target=grow, name="fleet-grow")
    t0 = time.perf_counter()
    t.start()
    outs = concurrently(lambda p: fleet.generate(p, timeout=FLEET_WAIT),
                        prompts)
    t.join(FLEET_WAIT)
    assert not t.is_alive() and "name" in grown, grown
    wall = time.perf_counter() - t0
    ties = [tie_rule(net, params, dev, p, o["tokens"], w, f"15a {i}")
            for i, (p, o, w) in enumerate(zip(prompts, outs, want))]
    by_engine = {}
    for o in outs:
        by_engine[o["engine"]] = by_engine.get(o["engine"], 0) + 1
    assert {"engine-0", "engine-1"} <= set(by_engine), by_engine
    new = fleet.router.handle_for(grown["name"])
    assert isinstance(new, LocalEngineHandle)
    for i in range(4):
        got = new.request("generate", prompts[i], timeout=FLEET_WAIT)
        ties.append(tie_rule(net, params, dev, prompts[i], got["tokens"],
                             want[i], f"15a grown {i}"))
    assert {n: h.engine.stats.compiles for n, h in handles.items()} == \
        compiles, "a sibling captured after warm-up"
    assert perf.snapshot()["anomalies"] == anomalies, \
        "CompileWatch counted a capture anomaly"
    gen = sum(len(o["tokens"]) for o in outs)
    log(f"[fleet] 15a {FLEET_N} greedy requests through the Router over 2 "
        f"engines while a third was grown (captured on another thread "
        f"in {grown['s']:.3f} s, the siblings replaying): {gen} tokens in "
        f"{wall:.3f} s, per engine {by_engine}; answers equal one "
        f"replayed engine's except {sum(x is not None for x in ties)} "
        f"(first index, top-2 gap: {[x for x in ties if x]}); no capture "
        f"after warm-up on a sibling, 0 capture anomalies")
    t0 = time.perf_counter()
    assert fleet.retire(grown["name"]) is True
    retire_s = time.perf_counter() - t0
    del new
    left = allocated(dev) - before_grow
    log(f"[fleet] 15a retire of {grown['name']}: {retire_s * 1e3:.3f} ms "
        f"(drained); device memory after it {left:+d} bytes against "
        f"before the grow (slack {MEM_SLACK})")
    assert left <= MEM_SLACK, left

    # router overhead: the router's wall time per request less the time
    # the engine's server reports for it, one request at a time
    over, lone = [], []
    for p in prompts[:8]:
        t0 = time.perf_counter()
        o = fleet.generate(p, timeout=FLEET_WAIT)
        total = (time.perf_counter() - t0) * 1e3
        over.append(total - o["latency_ms"])
        lone.append(total)
    log(f"[fleet] 15a router overhead per lone request: p50 "
        f"{float(np.median(over)):.3f} ms, max {max(over):.3f} ms, of "
        f"{float(np.median(lone)):.3f} ms p50 end to end "
        f"({FLEET_SPEC['max_new_tokens']} new tokens)")

    one = handles["engine-0"].server
    runs = {"fleet of 2": lambda: concurrently(
        lambda p: fleet.generate(p, timeout=FLEET_WAIT), prompts),
        "engine-0 alone": lambda: concurrently(
            lambda p: one.generate(p, timeout=FLEET_WAIT), prompts)}
    ms = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):     # in turns
        for k in order:
            t0 = time.perf_counter()
            runs[k]()               # ends with every answer on the host
            ms[k].append((time.perf_counter() - t0) * 1e3)
    for k, v in ms.items():
        log(f"[fleet] 15a {FLEET_N} concurrent requests, {k}: "
            + ", ".join(f"{t:.3f}" for t in v) + " ms in turns, "
            + ", ".join(f"{gen / t * 1e3:.1f}" for t in v)
            + " generated tokens/s")
    ratio = min(ms["engine-0 alone"]) / min(ms["fleet of 2"])
    log(f"[fleet] 15a fleet of 2 on one card: {ratio:.3f}x one engine's "
        f"tokens/s (best of each)")


def fleet_b(dev, fleet, ws, arrays):
    """15b: a healthy save canaries one engine and is promoted; a
    diverged one canaries one and is rolled back; never two engines on
    a canary step, no request fails."""
    import threading
    from singa_tpu_torch import CheckpointManager
    mgr = CheckpointManager(ws, log_fn=log)
    ctrl = fleet.rollout
    stop, errors, served = threading.Event(), [], []
    prompts = fleet_traffic(BENCH["vocab_size"], n=8, seed=16)

    def traffic(i):
        while not stop.is_set():
            try:
                fleet.generate(prompts[i % len(prompts)],
                               timeout=FLEET_WAIT)
                served.append(i)
            except Exception as e:  # noqa: BLE001 — counted, then fails
                errors.append(repr(e))
            i += 4

    def watch(step, done, tag):
        """Poll every 2 ms until `done()`: the most engines seen on
        `step` while the canary's window was open and at all, the time
        the canary began serving (its reload done) and the time of the
        verdict."""
        most, most_canary, t_canary = 0, 0, None
        deadline = time.monotonic() + FLEET_WAIT
        while not done():
            assert time.monotonic() < deadline, (tag, ctrl.snapshot())
            state = ctrl.state
            # the window is open until its deadline; the promotion's
            # reloads of the others come after it, still in CANARY
            window = time.monotonic() < ctrl._deadline - 0.05
            steps = fleet_steps(fleet)
            on = sum(s == step for s in steps.values())
            most = max(most, on)
            if state == "CANARY" and window and ctrl.state == "CANARY":
                most_canary = max(most_canary, on)
            if t_canary is None and state == "CANARY":
                t_canary = time.perf_counter()
                canary = ctrl.canary
                if canary is not None and tag == "promote":
                    # fault C5 on the card: the canary's reload moved
                    # its own params only
                    other = next(n for n in steps if n != canary)
                    live = fleet.router.handle_for(other).engine.params
                    assert all(torch.equal(live[k], clones[other][k])
                               for k in live), "C5: a sibling moved"
            time.sleep(0.002)
        return most, most_canary, t_canary, time.perf_counter()

    clones = {n: {k: v.clone() for k, v in
                  fleet.router.handle_for(n).engine.params.items()}
              for n in fleet.router.names()}
    workers = [threading.Thread(target=traffic, args=(i,))
               for i in range(4)]          # 4 clients, one request each
    for w in workers:
        w.start()
    try:
        assert ctrl.pinned_step < 10, ctrl.pinned_step
        t0 = time.perf_counter()
        mgr.save(10, arrays, {"t": np.zeros((), np.float32)},
                 health={"verdict": "ok"})
        t_saved = time.perf_counter()
        most, most_c, t_c, t_d = watch(10, lambda: ctrl.promotions == 1,
                                       "promote")
        assert most_c == 1 and t_c is not None, most_c
        steps = fleet_steps(fleet)
        assert set(steps.values()) == {10}, steps
        copy = {n: round(fleet.router.handle_for(n).engine.reload_copy_ms,
                         3) for n in steps}
        log(f"[fleet] 15b healthy save of step 10 ({t_saved - t0:.3f} s "
            f"to write): on exactly one engine during the canary's window "
            f"(serving {(t_c - t_saved) * 1e3:.3f} ms after the save), "
            f"promoted {(t_d - t_c) * 1e3:.3f} ms after the canary began "
            f"serving (window {ctrl.spec.window_s} s); reload copy_ ms per "
            f"engine {copy}; the sibling's params unchanged under "
            f"torch.equal while the canary served (C5)")
        del clones
        t0 = time.perf_counter()
        mgr.save(20, arrays, {"t": np.zeros((), np.float32)},
                 health={"verdict": "diverged"})
        t_saved = time.perf_counter()
        most, most_c, t_c, t_d = watch(20, lambda: ctrl.rollbacks == 1,
                                       "rollback")
        assert most == 1 and t_c is not None, most
        steps = fleet_steps(fleet)
        assert set(steps.values()) == {10}, steps
        log(f"[fleet] 15b diverged save of step 20 ({t_saved - t0:.3f} s "
            f"to write): on at most {most} engine at any time, rolled "
            f"back {(t_d - t_c) * 1e3:.3f} ms after the canary began "
            f"serving; the rollback's copy_ "
            + ", ".join(f"{n} {fleet.router.handle_for(n).engine.reload_copy_ms:.3f}"
                        for n in steps) + " ms (last reload of each)")
    finally:
        stop.set()
        for w in workers:
            w.join(FLEET_WAIT)
    assert not any(w.is_alive() for w in workers)
    assert not errors and fleet.router.stats.failed == 0, errors[:3]
    # fault C6: a reader in a first save's window refused it
    assert ctrl.refusals == 0, ctrl.snapshot()
    log(f"[fleet] 15b {len(served)} requests served through both rollouts, "
        f"0 failed; rollout {ctrl.snapshot()}")


def fleet_c(dev, net, fleet):
    """15c: 3 concurrent 128-token streams on one engine; a sibling is
    revived (its graphs reused), then the streams' engine is killed
    mid-decode: each completes exactly once, spliced, tokens equal the
    uninterrupted streams under the tie rule."""
    import threading
    e0, e1 = (fleet.router.handle_for(n) for n in ("engine-0", "engine-1"))
    params = e0.engine.params
    prompts = fleet_traffic(BENCH["vocab_size"], n=FLEET_STREAMS, seed=17)
    mn = FLEET_SPEC["max_new_tokens"]
    ref = [[ev["token"] for ev in fleet.generate_stream(
        p, max_new=mn, timeout=FLEET_WAIT) if "token" in ev]
        for p in prompts]
    e1.kill()
    fleet.router.probe_all()
    assert fleet.router.healthy_names() == ["engine-0"]
    events = [[] for _ in prompts]
    dones = [None] * len(prompts)

    def consume(i):
        for ev in fleet.generate_stream(prompts[i], max_new=mn,
                                        timeout=FLEET_WAIT):
            events[i].append((time.perf_counter(), ev))
            if ev.get("done"):
                dones[i] = ev
    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + FLEET_WAIT
    while min(len(e) for e in events) < 4:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    compiles = e1.engine.stats.compiles
    e1.revive()
    assert e1.engine.stats.compiles == compiles, "revive captured again"
    while "engine-1" not in fleet.router.healthy_names():
        assert time.monotonic() < deadline
        fleet.router.probe_all()
        time.sleep(0.005)
    sessions = fleet.router.sessions.snapshot()["sessions"]
    assert {s["engine"] for s in sessions} == {"engine-0"}, sessions
    at = [len(e) for e in events]
    t_kill = time.perf_counter()
    e0.kill()
    for t in threads:
        t.join(FLEET_WAIT)
    assert not any(t.is_alive() for t in threads)
    firsts, ties = [], []
    for i, (evs, done) in enumerate(zip(events, dones)):
        toks = [ev for _, ev in evs if "token" in ev]
        assert [ev["i"] for ev in toks] == list(range(mn)), i
        assert done["spliced"] and done["resumes"] == 1, done
        assert done["engine"] == "engine-1", done
        ties.append(tie_rule(net, params, dev, prompts[i],
                             [ev["token"] for ev in toks], ref[i],
                             f"15c stream {i}"))
        firsts.append(next((ts - t_kill) * 1e3 for ts, ev in evs
                           if ts > t_kill and "token" in ev))
    snap = fleet.router.sessions.snapshot()
    assert snap["dup_tokens"] == 0 and snap["gap_events"] == 0, snap
    log(f"[fleet] 15c {FLEET_STREAMS} streams of {mn} tokens, engine-0 "
        f"killed after {at} events: every index exactly once, all spliced "
        f"onto engine-1 (revived with its graphs, 0 captures); tokens "
        f"equal the uninterrupted streams except "
        f"{[x for x in ties if x]} (first index, top-2 gap); kill to the "
        f"first spliced token "
        + ", ".join(f"{x:.3f}" for x in firsts) + " ms")
    e0.revive()


def phase_fleet(dev, arrays, cfg=BENCH):
    """15a-15c on the bench stack in f32 (`cfg` cuts it for a rehearsal
    on the CPU)."""
    import shutil
    import tempfile
    from singa_tpu_torch import params_from_numpy, numpy_params
    from singa_tpu_torch.serve import (EngineFleet, RolloutSpec, RouterSpec,
                                       ServeSpec)
    net = build(cfg, cfg["seq_len"])
    params = params_from_numpy(net, arrays, device=dev)
    spec = ServeSpec(**FLEET_SPEC)
    prompts = fleet_traffic(cfg["vocab_size"])
    want = fleet_reference(net, params, dev, spec, prompts)
    base = allocated(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ws = tempfile.mkdtemp(prefix="fleet-", dir=os.path.join(REPO, "build"))
    fleet = EngineFleet.local(
        net, spec, 2, workspace=ws, params=params,
        router_spec=RouterSpec(probe_period_s=0.05, quarantine_after=1,
                               readmit_base_s=0.05, readmit_cap_s=0.1,
                               hedge="off", request_timeout_s=FLEET_WAIT),
        rollout_spec=RolloutSpec(poll_s=0.02, window_s=1.0),
        device=dev, log_fn=lambda s: None)
    try:
        t0 = time.perf_counter()
        fleet.start()
        warm = time.perf_counter() - t0
        per = (allocated(dev) - base) / 2
        peak = (torch.cuda.max_memory_allocated() - base
                if dev == "cuda" else 0)
        log(f"[fleet] 15a EngineFleet.local(2) on the bench stack in f32 "
            f"(cb 8 slots): started in {warm:.3f} s (load, warm-up, "
            f"captures {[h.engine.stats.compiles for h in fleet._local]}); "
            f"{per / 2**20:.1f} MiB allocated per engine, peak "
            f"{peak / 2**20:.1f} MiB over both")
        fleet_a(dev, net, params, fleet, prompts, want)
        fleet_b(dev, fleet, ws, numpy_params(net, seed=1))
        fleet_c(dev, net, fleet)
    finally:
        fleet.stop()
        shutil.rmtree(ws, ignore_errors=True)


def phase_autoscale(dev, conf=LM_CONF, load=SCALE_LOAD):
    """15d: the AutoScaler over a fleet on lm.conf (f32, cb) under
    TrafficGen's ramp, flash crowd and quiet: grows under the flash (a
    capture while a sibling replays), shrinks after the quiet, 0 failed,
    0 dropped by the harness, and the memory comes back."""
    from singa_tpu_torch import build_net, load_model_config
    from singa_tpu_torch.data.discovery import discover_input_shapes
    from singa_tpu_torch.serve import (AutoScaler, AutoScaleSpec,
                                       EngineFleet, RouterSpec, ServeSpec,
                                       TrafficGen, flash_crowd, ramp, steady)
    from singa_tpu_torch.weights import numpy_params, params_from_numpy
    model = load_model_config(conf)
    net = build_net(model, "kTrain",
                    discover_input_shapes(model, force_synthetic=True))
    params = params_from_numpy(net, numpy_params(net, seed=0), device=dev)
    fleet = EngineFleet.local(
        net, ServeSpec(**SCALE_SPEC), 1, params=params,
        router_spec=RouterSpec(probe_period_s=0.05, hedge="off",
                               request_timeout_s=120.0),
        device=dev, log_fn=lambda s: None).start()
    times = {"grow": [], "retire": []}

    def timed(kind, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            times[kind].append(time.perf_counter() - t0)
            return out
        return call
    fleet.grow = timed("grow", fleet.grow)
    fleet.retire = timed("retire", fleet.retire)
    scaler = AutoScaler(fleet, spec=AutoScaleSpec(
        min_engines=1, max_engines=3, cooldown_s=0.5, window_s=1.0,
        tick_s=0.1, quiet_ticks=5, slo_p95_ms=2000.0), log_fn=log)
    before = allocated(dev)
    vocab = next(layer.vocab_size for layer in net.layers.values()
                 if isinstance(getattr(layer, "vocab_size", None), int))
    gen = TrafficGen(lambda toks: fleet.generate(toks, timeout=120.0),
                     vocab=vocab, seed=15, max_outstanding=8192,
                     log_fn=lambda s: None)
    (rd, r0, r1), (fd, fb, fk), (qd, qr) = (load["ramp"], load["flash"],
                                            load["quiet"])
    scaler.start()
    try:
        rep = gen.run([ramp("ramp", rd, r0, r1),
                       flash_crowd("flash", fd, fb, k=fk),
                       steady("quiet", qd, qr)], drain_timeout_s=120.0)
        deadline = time.monotonic() + 60.0
        while scaler.scale_downs < 1 or scaler._busy or \
                len(fleet.router.names()) > 1:
            assert time.monotonic() < deadline, scaler.snapshot()
            time.sleep(0.05)
    finally:
        scaler.stop()
    try:
        tot = rep["totals"]
        snap = scaler.snapshot()
        assert tot["failed"] == 0 and tot["dropped_harness"] == 0, tot
        assert snap["scale_ups"] >= 1 and snap["scale_downs"] >= 1, snap
        left = allocated(dev) - before
        for row in rep["phases"]:
            log(f"[scale] 15d phase {row['name']}: offered "
                f"{row['offered']}, completed {row['completed']}, shed "
                f"{row['shed']}, failed {row['failed']}, p50/p95/p99 "
                f"{row.get('p50_ms')}/{row.get('p95_ms')}/"
                f"{row.get('p99_ms')} ms")
        log(f"[scale] 15d autoscaler on lm.conf: {snap['scale_ups']} "
            f"grows, {snap['scale_downs']} retires, engines back to "
            f"{len(fleet.router.names())}; grow (spawn, load, warm-up "
            f"captures, join) "
            + ", ".join(f"{t * 1e3:.3f}" for t in times["grow"])
            + " ms; retire (drain, stop) "
            + ", ".join(f"{t * 1e3:.3f}" for t in times["retire"])
            + f" ms; 0 failed, 0 dropped; device memory after the shrink "
            f"{left:+d} bytes against before the first grow (slack "
            f"{MEM_SLACK})")
        assert left <= MEM_SLACK, left
    finally:
        fleet.stop()


def start_worker(dev, i, tmp, conf):
    """One `serve --pinned --wire` worker process with telemetry on; its
    log goes to a file."""
    path = os.path.join(tmp, f"worker-{i}.log")
    obs_spec = (f"trace={tmp}/w{i}.json,events={tmp}/w{i}.jsonl,"
                f"flightrec={tmp}/fr{i},trace_ring=4096,process=worker-{i}")
    out = open(path, "w")
    cmd, started = spawn(
        main_cmd(dev) + ["serve", "-model_conf", conf, "--pinned", "--wire",
                         "--port", "0", "--serve_spec", PROC_SPEC, "--obs",
                         "on", "--obs_spec", obs_spec], f"15e worker {i}")
    proc = subprocess.Popen(
        cmd, cwd=REPO, env=dict(os.environ, PYTHONUNBUFFERED="1"),
        stdout=out, stderr=subprocess.STDOUT)
    proc.started = started
    out.close()
    return proc, path


def worker_url(proc, path, deadline):
    while True:
        with open(path) as f:
            text = f.read()
        if "wire on" in text:
            line = next(ln for ln in text.splitlines()
                        if "serve: http on " in ln)
            return "http://" + line.split("http on ")[1].split()[0]
        if proc.poll() is not None or time.monotonic() > deadline:
            print(text[-4000:], file=sys.stderr)
            raise AssertionError(f"worker {path} never served")
        time.sleep(0.05)


def phase_procs(dev, conf=LM_CONF):
    """15e: two worker processes adopted over the wire, a SIGKILL spliced
    across, one merged trace; and `serve --fleet 2 --smoke 8`, a third
    process started with the workers (their start-ups overlap)."""
    import shutil
    import tempfile
    import threading
    from singa_tpu_torch import obs
    from singa_tpu_torch.obs import collect
    from singa_tpu_torch.serve import (EngineFleet, NegotiatingEngineHandle,
                                       RouterSpec)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="procs-", dir=os.path.join(REPO, "build"))
    procs, smoke = [], None
    try:
        t0 = time.perf_counter()
        smoke_out = open(os.path.join(tmp, "smoke.log"), "w")
        cmd, started = spawn(main_cmd(dev) + [
            "serve", "--fleet", "2", "--smoke", "8", "-model_conf", conf],
            "15e serve --fleet 2 --smoke 8")
        smoke = subprocess.Popen(cmd, cwd=REPO, stdout=smoke_out,
                                 stderr=subprocess.STDOUT)
        smoke.started = started
        smoke_out.close()
        procs = [start_worker(dev, i, tmp, conf) for i in range(2)]
        deadline = time.monotonic() + FLEET_WAIT
        urls = [worker_url(p, path, deadline) for p, path in procs]
        log(f"[procs] 15e two `serve --pinned --wire` workers on "
            f"lm.conf serving in {time.perf_counter() - t0:.3f} s")
        hosts = os.path.join(tmp, "hosts")
        with open(hosts, "w") as f:
            f.write("".join(u.split("//", 1)[1] + "\n" for u in urls))
        with obs.session(obs.ObsSpec(process="router", trace_ring=65536)):
            fleet = EngineFleet.from_hostfile(
                hosts, router_spec=RouterSpec(
                    probe_period_s=0.1, quarantine_after=1, hedge="off",
                    request_timeout_s=120.0),
                transport="auto", log_fn=lambda s: None).start()
            try:
                hs = [fleet.router.handle_for(n) for n in
                      fleet.router.names()]
                assert all(isinstance(h, NegotiatingEngineHandle)
                           and h.transport == "binary" for h in hs), \
                    [h.transport for h in hs]
                prompt = np.arange(1, 13, dtype=np.int32)
                out = fleet.generate(prompt, timeout=120.0)
                tid = fleet.router.requests.snapshot()["recent"][-1]["trace"]
                merged = collect.collect(urls, extra_buffers=[
                    obs.trace_dump()])
                spans = collect.spans_of(merged, tid)
                names = {e["name"] for e in spans}
                assert {"router.dispatch", "serve.request"} <= names, names
                assert len({e["pid"] for e in spans}) >= 2
                assert collect.orphans(merged, tid) == []
                log(f"[procs] 15e both workers negotiated the wire; one "
                    f"request's trace {tid}: {len(spans)} spans over "
                    f"{len({e['pid'] for e in spans})} processes merged "
                    f"by obs.collect, 0 orphans")
                events, done = [], {}

                def consume():
                    for ev in fleet.generate_stream(prompt, max_new=128,
                                                    timeout=120.0):
                        events.append((time.perf_counter(), ev))
                        if ev.get("done"):
                            done.update(ev)
                t = threading.Thread(target=consume)
                t.start()
                deadline = time.monotonic() + 120.0
                while len(events) < 8:
                    assert time.monotonic() < deadline and t.is_alive()
                    time.sleep(0.001)
                serving = fleet.router.sessions.snapshot()[
                    "sessions"][0]["engine"]
                victim = procs[int(serving.split("-")[1])][0]
                at = len(events)
                t_kill = time.perf_counter()
                victim.kill()
                t.join(120.0)
                assert not t.is_alive()
                toks = [ev for _, ev in events if "token" in ev]
                assert [ev["i"] for ev in toks] == list(range(128))
                assert done["spliced"] and done["resumes"] == 1, done
                assert done["engine"] != serving, done
                first = next((ts - t_kill) * 1e3 for ts, ev in events
                             if ts > t_kill and "token" in ev)
                log(f"[procs] 15e {serving}'s process SIGKILLed after "
                    f"{at} events of a 128-token stream: spliced "
                    f"onto {done['engine']} exactly once (indices 0-127 "
                    f"once each, 1 resume); kill to the first spliced "
                    f"token {first:.3f} ms")
            finally:
                fleet.stop()
        code = smoke.wait(600)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "smoke.log")) as f:
            text = f.read()
        if code != 0:
            print(text[-6000:], file=sys.stderr)
        assert code == 0, code
        snap = json.loads([ln for ln in text.splitlines()
                           if ln.startswith("{")][-1])
        assert snap["completed"] == 8 and snap["failed"] == 0, snap
        per = {e["name"]: e["dispatched"] for e in snap["engines"]}
        log(f"[procs] 15e `serve --fleet 2 --smoke 8 -model_conf "
            f"lm.conf`: exit 0, {wall:.3f} s wall from its start (process "
            f"start, import, 2 engines' load and captures, 8 requests; "
            f"it started beside the two workers and ran beside the "
            f"steps above); dispatched {per}, latency p50 "
            f"{snap['p50_latency_ms']} ms")
    finally:
        for p in [p for p, _ in procs] + ([smoke] if smoke else []):
            p.kill()
            p.wait(30)
            p.started(p.returncode)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_control(dev, arrays, cfg=BENCH, conf=LM_CONF, load=SCALE_LOAD):
    """Phase 15; the arguments cut it down for a rehearsal on the CPU.
    The serving path launches none of K1-K6."""
    from singa_tpu_torch.ops import _kernels
    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] phase 15{what}: {now - clock[0]:.1f} s")
        clock[0] = now
    _kernels.reset_launches()
    phase_fleet(dev, arrays, cfg)
    took("a-c")
    phase_autoscale(dev, conf, load)
    took("d")
    phase_procs(dev, conf)
    took("e")
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    log("[fleet] phase 15: 0 launches of K1-K6 on the fleet path")
    if dev == "cuda":
        torch.cuda.empty_cache()


# phase 16: the pipeline subcommand on lm.conf uncut
PIPE_STEPS = 60
PIPE_CKPT = 10          # the cadence written into the copy of lm.conf
# a preemption before step 25 (attempt 2 restores step 20), then a spike
# at step 35 (the step.grad site's visit 40: 25 visits before the
# restart, 15 after it): the save of step 40 carries the verdict "spike"
PIPE_FAULTS = "step.train@25:preempt,step.grad@40:spike"
PIPE_SPIKE = 40
PIPE_TRAINED = PIPE_STEPS + 5   # steps 20-24 run twice
PIPE_SPEC = "buckets=1x16,max_new_tokens=16"
PIPE_ROLLOUT = "poll_s=0.05,window_s=0.25,min_requests=1"
PIPE_AUTOSCALE = "min_engines=1,max_engines=3,tick_s=0.1,cooldown_s=0.5"
PIPE_SMOKE = 32         # the CLI's client requests, at least
PIPE_ANSWERS = 8        # prompts held against a fresh engine at the end
PIPE_WAIT = 120.0       # every wait of this phase is bounded
PIPE_HOLD = 30.0        # the trainer's hold at the spike save


def pipe_trainer(dev, conf, ws):
    """(trainer, supervisor, batch factory, tokens a step) of the
    supervised run on `conf`, as `pipeline_main` builds them."""
    from singa_tpu_torch import Trainer, load_model_config
    from singa_tpu_torch.core.supervisor import Supervisor
    from singa_tpu_torch.data import (discover_input_shapes,
                                      resolve_data_source)
    from singa_tpu_torch.utils.health import HealthMonitor, HealthSpec
    model = load_model_config(conf)
    model.train_steps = PIPE_STEPS
    shapes = discover_input_shapes(model, force_synthetic=True)
    tr = Trainer(model, shapes, device=dev, log_fn=lambda m: None,
                 health=HealthMonitor(HealthSpec(), log_fn=lambda m: None))
    sup = Supervisor(tr, ws, max_restarts=3, log=lambda m: None)
    p = next(l for l in model.neuralnet.layer if l.type == "kSequenceData")

    def factory():
        return resolve_data_source(model, p.seqdata_param.batchsize, seed=0,
                                   force_synthetic=True,
                                   sample_shapes=shapes)[0]
    return tr, sup, factory, p.seqdata_param.batchsize * \
        p.seqdata_param.seq_len


def pipe_alone(dev, conf, ws):
    """The pipeline's training run without the fleet: tokens/s."""
    from singa_tpu_torch.utils.faults import FaultSchedule, inject
    tr, sup, factory, tokens = pipe_trainer(dev, conf, ws)
    trained = []
    with inject(FaultSchedule.parse(PIPE_FAULTS, seed=0)):
        t0 = time.perf_counter()
        sup.run(factory, seed=0, hooks=[lambda s, m: trained.append(s)])
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert [f.kind for f in sup.failures] == ["preemption"], sup.failures
    assert len(trained) == PIPE_TRAINED, len(trained)
    return len(trained) * tokens / wall


def pipe_fleet(dev, conf, ws, vocab):
    """16a: the supervised run (PIPE_FAULTS) beside `EngineFleet.local(...,
    2)` on one workspace, under a `PipelineController`, one client
    sending requests until blessed == served; the trainer is held at
    the spike save until the rollout has decided on it (that wait is
    left out of its tokens/s).  Asserts the loop's invariants and holds
    the fleet's answers at the final step against a fresh engine."""
    from singa_tpu_torch.core.pipeline import PipelineController, PipelineSpec
    from singa_tpu_torch.serve import (EngineFleet, InferenceEngine,
                                       RolloutSpec, ServeSpec, left_pad)
    from singa_tpu_torch.utils.faults import FaultSchedule, inject
    tr, sup, factory, tokens = pipe_trainer(dev, conf, ws)
    net = tr.test_net or tr.train_net
    spec = ServeSpec.parse(PIPE_SPEC)
    t0 = time.perf_counter()
    fleet = EngineFleet.local(net, spec, 2, workspace=ws,
                              params=net.init_params(0, device=dev),
                              rollout_spec=RolloutSpec.parse(PIPE_ROLLOUT),
                              device=dev,
                              log_fn=lambda m: log(f"[pipe] 16a {m}"))
    ctl = PipelineController(sup, fleet, ws,
                             spec=PipelineSpec(lag_alarm_s=60.0),
                             log_fn=lambda m: None)
    publish, held, trained, wall = tr.on_checkpoint, [0.0], [], [0.0]
    judged = []

    def on_checkpoint(step, verdict):
        publish(step, verdict)
        if verdict == "spike":
            # hold until the rollout has canaried this step and left it
            t, seen = time.perf_counter(), False
            while time.perf_counter() - t < PIPE_HOLD:
                seen = seen or fleet.rollout.target_step == step
                if seen and fleet.rollout.target_step != step:
                    judged.append((step, fleet.rollout.pinned_step))
                    break
                time.sleep(0.001)
            held[0] += time.perf_counter() - t
    tr.on_checkpoint = on_checkpoint
    run = sup.run

    def timed_run(*args, **kwargs):
        t = time.perf_counter()
        try:
            return run(*args, **kwargs)
        finally:
            if dev == "cuda":
                torch.cuda.synchronize()
            wall[0] = time.perf_counter() - t
    sup.run = timed_run
    rng = np.random.default_rng(16)
    responses, pinned_seen, failed = [], [], 0
    with inject(FaultSchedule.parse(PIPE_FAULTS, seed=0)):
        ctl.start(factory, seed=0, hooks=[lambda s, m: trained.append(s)])
        up = time.perf_counter() - t0
        try:
            deadline = time.monotonic() + PIPE_WAIT
            while True:
                done = not ctl.train_running()
                lag = ctl.lag()
                if done and lag["lag_steps"] == 0 and \
                        lag["blessed_step"] >= 0:
                    break
                assert time.monotonic() < deadline, ctl.snapshot()
                pinned = fleet.rollout.pinned_step
                pinned_seen.append(pinned)
                prompt = rng.integers(0, vocab, int(rng.integers(1, 17))
                                      ).astype(np.int32)
                try:
                    out = ctl.generate(prompt)
                    responses.append((pinned, out["step"], out["engine"]))
                except Exception as e:  # noqa: BLE001 — counted, must be 0
                    failed += 1
                    log(f"[pipe] 16a request failed: {type(e).__name__}: "
                        f"{e}")
            assert ctl.wait(timeout=PIPE_WAIT), "training never finished"
            assert ctl.train_error is None, ctl.train_error
            final = fleet.rollout.pinned_step
            prompts = [rng.integers(0, vocab, int(k)).astype(np.int32)
                       for k in rng.integers(4, 17, PIPE_ANSWERS)]
            outs = [ctl.generate(p) for p in prompts]
            rollout = dict(fleet.snapshot()["rollout"])
        finally:
            ctl.stop()
    assert [f.kind for f in sup.failures] == ["preemption"], sup.failures
    assert len(trained) == PIPE_TRAINED, len(trained)
    assert failed == 0, failed
    assert final == PIPE_STEPS and all(o["step"] == final for o in outs)
    assert all(s >= p for p, s, _ in responses), "a step below the pin"
    assert pinned_seen == sorted(pinned_seen), "the pinned step regressed"
    on_spike = {e for _, s, e in responses if s == PIPE_SPIKE}
    assert len(on_spike) <= 1, on_spike
    # the spike save was canaried and rolled back: never pinned
    assert len(judged) == 1 and judged[0][1] != PIPE_SPIKE, judged
    assert PIPE_SPIKE not in pinned_seen, pinned_seen
    assert rollout["rollbacks"] >= 1 and rollout["refusals"] == 0, rollout
    served = {s for _, s, _ in responses}
    assert served <= {-1, PIPE_SPIKE, *range(PIPE_CKPT, PIPE_STEPS + 1,
                                             PIPE_CKPT)}, served
    fresh = InferenceEngine(net, spec, net.init_params(0, device=dev),
                            device=dev, workspace=ws, log_fn=lambda m: None,
                            pinned=True)
    assert fresh.load() == final
    ties = []
    for i, (p, out) in enumerate(zip(prompts, outs)):
        want = fresh.run_batch("generate", *left_pad([p], spec.buckets[0]))
        tie = tie_rule(net, fresh.params, dev, p, out["tokens"],
                       want[0].tolist(), f"16a answer {i}")
        if tie is not None:
            ties.append(tie)
    lags = sorted(1e3 * x for x in ctl.promote_lags_s)
    return {"up_s": up, "wall": wall[0], "held": held[0],
            "tokens_s": len(trained) * tokens / (wall[0] - held[0]),
            "requests": len(responses), "failed": failed,
            "lags_ms": lags, "rollout": rollout, "spike_on": on_spike,
            "ties": ties, "served": sorted(served),
            "engines": sorted({e for _, _, e in responses})}


def pipe_cli(dev, conf, ws):
    """16b: the CLI's `pipeline ... --fleet 2 --smoke N` with the faults
    and the autoscaler (`main(argv)` in this process), and the kernel
    launches it made."""
    argv = ["pipeline", "-model_conf", conf, "--workspace", ws,
            "--synthetic", "--steps", str(PIPE_STEPS), "--fleet", "2",
            "--smoke", str(PIPE_SMOKE), "--serve_spec", PIPE_SPEC,
            "--rollout_spec", PIPE_ROLLOUT, "--fault_spec", PIPE_FAULTS,
            "--autoscale_spec", PIPE_AUTOSCALE]
    t0 = time.perf_counter()
    code, text, launches = run_main_launches(argv, dev)
    wall = time.perf_counter() - t0
    if code != 0:
        print(text[-8000:], file=sys.stderr)
    assert code == 0, code
    # the snapshot line; the fleet's shutdown may log after it
    snap = json.loads([line for line in text.splitlines()
                       if line.startswith("{")][-1])
    assert snap["blessed_step"] == snap["served_step"] == PIPE_STEPS, snap
    assert snap["lag_steps"] == 0 and snap["fleet"]["failed"] == 0, snap
    assert snap["train"]["error"] is None and \
        snap["train"]["failures"] == 1, snap["train"]
    assert snap["unblessed"] == 1 and "autoscale" in snap, snap
    return wall, snap, launches


def phase_pipeline(dev, conf=LM_CONF):
    """Phase 16; `conf` cuts it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    from singa_tpu_torch import build_net, load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    from singa_tpu_torch.ops import _kernels
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pipeline_", dir=os.path.join(REPO,
                                                                "build"))
    try:
        conf = cli_conf(tmp, conf, every=PIPE_CKPT)
        model = load_model_config(conf)
        net = build_net(model, "kTrain",
                        discover_input_shapes(model, force_synthetic=True))
        vocab = next(layer.vocab_size for layer in net.layers.values()
                     if isinstance(getattr(layer, "vocab_size", None), int))
        _kernels.reset_launches()
        runs, alone = [], []
        for turn in range(2):
            runs.append(pipe_fleet(dev, conf, os.path.join(
                tmp, f"fleet{turn}"), vocab))
            alone.append(pipe_alone(dev, conf, os.path.join(
                tmp, f"alone{turn}")))
        launches = {k: v for k, v in _kernels.LAUNCHES.items()
                    if k in ("flash_fwd", "flash_dq", "flash_dkv")}
        if dev == "cuda":
            # lm.conf: 2 attention layers, each step on the graphs' record
            want = 2 * PIPE_TRAINED * 4
            assert launches == {"flash_fwd": want, "flash_dq": want,
                                "flash_dkv": want}, launches
        r = runs[0]
        lags = [x for run in runs for x in run["lags_ms"]]
        log(f"[pipe] 16a pipeline on {os.path.basename(LM_CONF)} (B=8, "
            f"S=512, bf16, Adam, replayed; a save every {PIPE_CKPT} steps; "
            f"'{PIPE_FAULTS}') beside a fleet of 2 ({PIPE_SPEC}, f32): "
            f"fleet up in {r['up_s']:.3f} s; {r['requests']} and "
            f"{runs[1]['requests']} requests served, 0 failed; steps served "
            f"{r['served']} by {r['engines']}; blessed == served == "
            f"{PIPE_STEPS} at the end; the spike save (step {PIPE_SPIKE}) "
            f"served by {sorted(r['spike_on']) or 'no engine'} (the canary "
            f"at most) and rolled back (rollout {r['rollout']}); the pinned "
            f"step never regressed; {PIPE_ANSWERS} answers at step "
            f"{PIPE_STEPS} equal a fresh engine's"
            + (f" but for ties {r['ties']}" if r["ties"] else ""))
        log(f"[pipe] 16a blessed-to-served lag per blessed step, 2 runs: "
            f"p50 {np.percentile(lags, 50):.3f} ms, max {max(lags):.3f} ms "
            f"over {len(lags)} steps ({', '.join(f'{x:.3f}' for x in lags)})")
        log(f"[pipe] 16a training tokens/s in turns, inside the pipeline / "
            f"alone: " + "; ".join(f"{p['tokens_s']:.1f} / {a:.1f}"
                                   for p, a in zip(runs, alone))
            + f" ({np.mean([p['tokens_s'] for p in runs]) / np.mean(alone):.4f}x"
            f"; {PIPE_TRAINED} steps trained a run, saves and the restart "
            f"included, the spike hold {runs[0]['held']:.3f} and "
            f"{runs[1]['held']:.3f} s left out)")
        log(f"[pipe] 16a K1/K3/K4 launches over the phase's 4 in-process "
            f"runs: {launches}")
        wall, snap, cli_launches = pipe_cli(dev, conf,
                                            os.path.join(tmp, "cli"))
        if dev == "cuda":
            want = 2 * PIPE_TRAINED
            assert all(cli_launches[k] == want
                       for k in ("flash_fwd", "flash_dq", "flash_dkv")), \
                cli_launches
        log(f"[pipe] 16b the CLI's pipeline ... --fleet 2 --smoke "
            f"{PIPE_SMOKE} --fault_spec '{PIPE_FAULTS}' --autoscale_spec "
            f"'{PIPE_AUTOSCALE}' (main(argv) in this process): exit 0 in "
            f"{wall:.3f} s wall; blessed {snap['blessed_step']} "
            f"served {snap['served_step']}, {snap['fleet']['completed']} "
            f"requests, {snap['fleet']['failed']} failed, unblessed "
            f"{snap['unblessed']}, promote lag max "
            f"{snap['promote_lag_max_s']} s, autoscale "
            f"{ {k: snap['autoscale'].get(k) for k in ('scale_ups', 'scale_downs', 'engines')} }; "
            f"launches {cli_launches}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 17: the elastic tier on mlp.conf uncut
MLP_CONF = os.path.join(REPO, "examples", "mnist", "mlp.conf")
MLP_CLI_STEPS = 200     # syncs at 60, 68, ..., 196
MLP_EXACT_STEPS = 80    # replayed against eager: syncs at 60, 68, 76
MLP_GROUP_STEPS = 100   # a replica's steps in the 2-group runs
MLP_TIMED = 10
ASYNC_CLUSTER = "nworkers: 2\nnprocs_per_group: 1\nsynchronous: false\n"


def mlp_trainer(dev, conf, graphs=None, ngroups=1):
    from singa_tpu_torch import Trainer, load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    model = load_model_config(conf)
    return Trainer(model, discover_input_shapes(model, force_synthetic=True),
                   device=dev, log_fn=lambda m: None, graphs=graphs,
                   ngroups=ngroups)


def mlp_stream(tr, stream_seed=None):
    from singa_tpu_torch.data import resolve_data_source
    p = next(l for l in tr.cfg.neuralnet.layer if l.type == "kShardData")
    return resolve_data_source(tr.cfg, p.data_param.batchsize, seed=0,
                               force_synthetic=True,
                               stream_seed=stream_seed)[0]


def elastic_cli(dev, conf, steps):
    """17a: the CLI (`main(argv)` in this process) on mlp.conf
    `--synthetic --steps N` exits 0 past the warmup."""
    t0 = time.perf_counter()
    code, text = run_main(["-model_conf", conf, "--synthetic", "--steps",
                           str(steps)], dev)
    wall = time.perf_counter() - t0
    if code != 0:
        print(text[-8000:], file=sys.stderr)
    assert code == 0, code
    expect_in(text, "async consistency tier active: Elastic", "training done")
    return wall, [line for line in text.splitlines()
                  if "test:" in line][-1:]


def elastic_exact(dev, conf, steps):
    """17b: the same numpy-seeded run replayed and eager, params after
    every sync step equal under torch.equal; then a step's ms with and
    without an exchange, and the exchange alone against its bound."""
    from singa_tpu_torch import numpy_params, params_from_numpy
    from singa_tpu_torch.parallel.elastic import elastic_update
    states, seen, trainers = [], [], []
    for graphs in (None, False):
        tr = mlp_trainer(dev, conf, graphs)
        arrays = numpy_params(tr.train_net, seed=0)
        params = params_from_numpy(tr.train_net, arrays, device=dev)
        opt = tr.updater.init(params)
        ctl, orig, at = tr.elastic, tr.elastic.maybe_sync, {}

        def rec(step, p, rng=None, orig=orig, ctl=ctl, at=at):
            out = orig(step, p, rng=rng)
            if ctl.sync_now(step):
                at[step] = {k: v.clone() for k, v in out.items()}
            return out
        ctl.maybe_sync = rec
        tr.cfg.train_steps = steps
        it = mlp_stream(tr)
        try:
            params, opt, _ = tr.run(params, opt, it, seed=0)
        finally:
            it.close()
        assert tr.graphs == (graphs is None and dev == "cuda")
        states.append((params, opt, ctl.center))
        seen.append(at)
        trainers.append((tr, params, opt))
    syncs = sorted(seen[0])
    assert syncs == sorted(seen[1]) and len(syncs) >= 3, syncs
    for s in syncs:
        assert state_equal(seen[0][s], seen[1][s]), s
    assert state_equal(states[0], states[1])
    tr, params, opt = trainers[0]
    ctl = tr.elastic
    it = mlp_stream(tr, stream_seed=17)
    batch = next(it)
    it.close()
    u = tr.cfg.updater
    step = steps + u.sync_frequency - (steps - u.warmup_steps) % \
        u.sync_frequency

    def run(with_sync):
        sync(dev)
        t0 = time.perf_counter()
        for i in range(MLP_TIMED):
            s = step + i * u.sync_frequency
            tr.train_step(params, opt, batch, s)
            if with_sync:
                ctl.maybe_sync(s, params)
        sync(dev)
        return (time.perf_counter() - t0) / MLP_TIMED * 1e3
    plain, synced = [], []
    for _ in range(2):
        plain.append(run(False))
        synced.append(run(True))
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    center = ctl.center
    ex_ms = (time_ms(lambda: elastic_update(params, center, ctl.alpha), 20)
             if dev == "cuda" else float("nan"))
    bound = 4 * nbytes / PEAK_BYTES * 1e3
    return {"syncs": syncs, "plain": plain, "synced": synced,
            "ex_ms": ex_ms, "bound": bound, "nbytes": nbytes,
            "graphs": trainers[0][0].graphs}


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def elastic_groups(dev, conf, tmp, param_type, steps):
    """17c: 2 async worker groups from a cluster conf (synchronous: false)
    as `main._replica_groups` builds them: a `ReplicaSet` over the
    trainer's graphs; replica, center, snapshot and graph storages
    disjoint; each replica's loss falls."""
    from singa_tpu_torch.config import load_cluster_config
    from singa_tpu_torch.core.step_graph import leaves
    from singa_tpu_torch.parallel.elastic import ReplicaSet
    path = os.path.join(tmp, f"mlp_{param_type}.conf")
    with open(conf) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("updater {\n",
                             f'updater {{\n  param_type: "{param_type}"\n',
                             1))
    cl_path = os.path.join(tmp, "cluster.conf")
    with open(cl_path, "w") as f:
        f.write(ASYNC_CLUSTER)
    cluster = load_cluster_config(cl_path)
    ngroups = cluster.nworkers // cluster.nprocs_per_group
    tr = mlp_trainer(dev, path, ngroups=ngroups)
    assert tr.cfg.updater.momentum == 0.0
    rs = ReplicaSet(tr, ngroups, seed=0, bandwidth_mb_s=cluster.bandwidth,
                    nservers=cluster.nservers or 1)
    iters = [mlp_stream(tr, stream_seed=1000 * (g + 1))
             for g in range(ngroups)]
    t0 = time.perf_counter()
    try:
        center, hist = rs.run(iters, steps, seed=0)
    finally:
        for it in iters:
            it.close()
    wall = time.perf_counter() - t0
    trees = [rep[k] for rep in rs.replicas for k in ("params", "opt")]
    trees.append(center)
    trees += [c.snapshot for c in rs.controllers if c.snapshot is not None]
    if tr.graphs:
        trees += [tr._state["params"], tr._state["opt"]]
    ptrs = [v.data_ptr() for t in trees for v in leaves(t)]
    assert len(ptrs) == len(set(ptrs)), "replica storages overlap"
    falls = []
    for g in range(ngroups):
        loss = [h["loss"] for h in hist[g]]
        first, last = np.mean(loss[:5]), np.mean(loss[-5:])
        assert last < first, (param_type, g, first, last)
        falls.append((float(first), float(last)))
    return {"wall": wall, "falls": falls, "ptrs": len(ptrs),
            "ratio": [c.sample_ratio for c in rs.controllers],
            "graphs": tr.graphs, "ngroups": ngroups,
            "rounds": sum(1 for s in range(steps)
                          if rs.controllers[0].sync_now(s))}


def phase_elastic(dev, conf=MLP_CONF, cli_steps=MLP_CLI_STEPS,
                  exact_steps=MLP_EXACT_STEPS, group_steps=MLP_GROUP_STEPS):
    """Phase 17; the arguments cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    from singa_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="elastic_", dir=os.path.join(REPO, "build"))
    try:
        wall, tests = elastic_cli(dev, conf, cli_steps)
        tr = mlp_trainer(dev, conf, graphs=False)
        nsync = sum(1 for s in range(cli_steps) if tr.elastic.sync_now(s))
        log(f"[elastic] 17a the CLI -model_conf "
            f"{os.path.relpath(conf, REPO)} --synthetic --steps {cli_steps} "
            f"(main(argv) in this process): exit 0 in {wall:.3f} s wall; "
            f"{nsync} sync steps (the first seeds the center, "
            f"{nsync - 1} exchanges); {tests[0].strip() if tests else ''}"
            f"")
        ex = elastic_exact(dev, conf, exact_steps)
        log(f"[elastic] 17b {exact_steps} steps replayed (graphs "
            f"{ex['graphs']}) and eager from numpy seed 0: params after the "
            f"sync steps {ex['syncs']} and at the end, the SGD history "
            f"and the center equal under torch.equal")
        log(f"[elastic] 17b a replayed step {', '.join(f'{x:.3f}' for x in ex['plain'])}"
            f" ms, with its exchange (validation's norm and host sync "
            f"included) {', '.join(f'{x:.3f}' for x in ex['synced'])} ms "
            f"(2 rounds of {MLP_TIMED}, in turns); the exchange alone "
            f"(`elastic_update`, {ex['nbytes'] / 1e6:.1f} MB of params) "
            f"{ex['ex_ms']:.4f} ms against its bound {ex['bound']:.4f} ms "
            f"(r and c read and written at {PEAK_BYTES / 1e12:.2f} TB/s)")
        for param_type in ("Elastic", "RandomSync"):
            g = elastic_groups(dev, conf, tmp, param_type, group_steps)
            log(f"[elastic] 17c {g['ngroups']} async groups x {param_type} "
                f"(cluster conf synchronous: false), {group_steps} steps "
                f"each over the trainer's graphs ({g['graphs']}) in "
                f"{g['wall']:.3f} s, {g['rounds']} sync rounds each: "
                f"{g['ptrs']} tensors of replicas, center, snapshots and "
                f"graphs, all disjoint; loss (mean of the first 5 -> last "
                f"5) " + ", ".join(f"{a:.5f} -> {b:.5f}"
                                   for a, b in g["falls"])
                + f"; sample ratio {g['ratio']}")
        cl = os.path.join(tmp, "cluster.conf")
        code, text = run_main(["-model_conf", conf, "-cluster_conf", cl,
                               "--synthetic", "--steps", str(exact_steps)],
                              dev)
        assert code == 0, text[-3000:]
        expect_in(text, "async replica groups: 2 x Elastic",
                  "training done (center of 2 replicas)", "center test:")
        center = [line for line in text.splitlines() if "center test" in line]
        log(f"[elastic] 17c the CLI with that cluster conf, {exact_steps} "
            f"steps: exit 0; {center[-1].strip()}")
        assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
        log("[elastic] phase 17: 0 launches of K1-K6 on the MLP path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: checkpoints the JAX package wrote through orbax

CKPT_FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "orbax")
CKPT_CORPUS = os.path.join(REPO, "tests", "torch_fixtures", "zstd")
# every mode the plain decoder counts that 18a's frames must take
CKPT_MODES = ("block.raw", "block.rle", "block.compressed", "literals.raw",
              "literals.rle", "literals.compressed", "literals.treeless",
              "literals.streams.1", "literals.streams.4", "huffman.fse",
              "huffman.direct", "table.predefined", "table.rle", "table.fse",
              "table.repeat", "frame.checksum", "frame.skippable")
CKPT_LM_CONF = os.path.join(REPO, "examples", "transformer", "lm_tiny.conf")
CKPT_ROUNDS = 3         # restores with each decoder, in turns
CKPT_DECODES = 3        # passes of the native decoder over every frame
CKPT_TRAIN_TO = 8       # the conv.conf fixture's step 4, trained on to 8
CKPT_PROMPTS = 2        # 18d: greedy prompts of the lm_tiny fixture


def ckpt_hashes() -> dict:
    with open(os.path.join(CKPT_FIXTURES, "hashes.json")) as f:
        return json.load(f)


def ckpt_copy(tmp, name, as_=None):
    import shutil
    dst = os.path.join(tmp, as_ or name)
    shutil.copytree(os.path.join(CKPT_FIXTURES, name), dst)
    return dst


def ckpt_leaves(params, opt) -> dict:
    """{`|`-joined key path: numpy leaf} of a restored state, as
    hashes.json names them."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}|")
            else:
                if isinstance(v, torch.Tensor):
                    v = v.detach().float().cpu().numpy() \
                        if v.dtype == torch.bfloat16 else v.cpu().numpy()
                out[f"{prefix}{k}"] = np.asarray(v)
    walk({"params": params, "opt_state": opt}, "")
    return out


def ckpt_check(leaves, rec, what):
    """Each leaf's dtype, shape and sha256 equal to the recorded ones."""
    import hashlib
    assert set(leaves) == set(rec["leaves"]), \
        (what, sorted(set(leaves) ^ set(rec["leaves"])))
    for k, v in leaves.items():
        d = rec["leaves"][k]
        got = [v.dtype.str, list(v.shape), hashlib.sha256(
            np.ascontiguousarray(v).tobytes()).hexdigest()]
        assert got == [d["dtype"], d["shape"], d["sha256"]], (what, k)


def ckpt_frames(ws):
    """(zstd frames, encoded files) of an orbax workspace: the frame of
    every manifest and node the reader reads, and every zarr chunk, of
    each step's OCDBT database and of the per-process ones under it."""
    from singa_tpu_torch.utils.ocdbt import OcdbtStore
    from singa_tpu_torch.utils.zstd import Codec
    frames, encoded = [], []
    ckpt = os.path.join(ws, "checkpoints")
    for step in sorted(s for s in os.listdir(ckpt) if s.isdigit()):
        top = os.path.join(ckpt, step, "default")
        # the step's tree holds every value; the per-process trees under
        # it refer to the same bytes, so only their nodes are added
        for root in [top] + [os.path.join(top, d)
                             for d in sorted(os.listdir(top))
                             if d.startswith("ocdbt.process_")]:
            store = OcdbtStore(root, Codec(native=False))
            for path, off, length in store.encoded:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(length)
                # format version 0, zstd (one byte each)
                assert data[12:14] == b"\x00\x01", (path, data[12:14])
                encoded.append(data)
                frames.append(data[14:-4])
            for key in store.list() if root == top else ():
                if not key.endswith((".zarray", "zarr.json")):
                    frames.append(store.read(key))
    return frames, encoded


def ckpt_corpus():
    """[(name, frame, record)] of the committed zstd corpus: frames that
    libzstd wrote at levels -5 to 19, with content checksums and a
    skippable frame, the sha256 of the bytes each was made from."""
    with open(os.path.join(CKPT_CORPUS, "corpus.json")) as f:
        corpus = json.load(f)
    out = []
    for name, rec in sorted(corpus.items()):
        with open(os.path.join(CKPT_CORPUS, name), "rb") as f:
            out.append((name, f.read(), rec))
    return out


def ckpt_decoders(names):
    """18a: the native decoder against the plain one on every frame of
    the fixtures and of the zstd corpus, byte for byte (the corpus also
    against its recorded sha256), with the plain decoder's mode counts
    over them all; both raise `ZstdError` on each corpus frame cut in
    half or with its first block's type made reserved; CRC32C on every
    encoded file and frame; single-threaded decode rates of each over
    the fixtures' frames."""
    import hashlib
    from collections import Counter
    from singa_tpu_torch.utils import zstd
    native = zstd.Codec(native=True)
    frames, encoded = [], []
    for name in names:
        f, e = ckpt_frames(os.path.join(CKPT_FIXTURES, name))
        frames += f
        encoded += e
    counts = Counter()
    t0 = time.perf_counter()
    plain = [zstd.decompress(f, counts) for f in frames]
    plain_s = time.perf_counter() - t0
    native_s = []
    for _ in range(CKPT_DECODES):
        t0 = time.perf_counter()
        got = [native.decompress(f) for f in frames]
        native_s.append(time.perf_counter() - t0)
        assert all(bytes(g) == p for g, p in zip(got, plain))
    corpus = ckpt_corpus()
    bad = 0
    for name, frame, rec in corpus:
        want = zstd.decompress(frame, counts)
        assert (len(want), hashlib.sha256(want).hexdigest()) == (
            rec["size"], rec["sha256"]), name
        assert bytes(native.decompress(frame)) == want, name
        if len(frame) < 64:
            continue
        half = frame[:len(frame) // 2]
        reserved = bytearray(frame)
        fhd = frame[4]
        single = (fhd >> 5) & 1
        reserved[5 + (1 - single) + (single, 2, 4, 8)[fhd >> 6]] |= 0x06
        if frame[:4] != zstd.MAGIC.to_bytes(4, "little"):
            reserved = None         # begins with a skippable frame
        for cut in (half, reserved):
            if cut is None:
                continue
            for decode in (zstd.decompress, native.decompress):
                try:
                    decode(bytes(cut))
                except zstd.ZstdError:
                    continue
                raise AssertionError(f"{name}: a cut frame decoded")
            bad += 1
    for data in encoded:
        stored = int.from_bytes(data[-4:], "little")
        assert native.crc32c(data[:-4]) == zstd.crc32c(data[:-4]) == stored
    for _, frame, _ in corpus:
        assert native.crc32c(frame) == zstd.crc32c(frame)
    missing = [m for m in CKPT_MODES if counts[m] == 0]
    assert not missing, (missing, counts)
    out_bytes = sum(len(p) for p in plain)
    return {"frames": len(frames), "encoded": len(encoded),
            "corpus": len(corpus), "bad": bad,
            "modes": {m: counts[m] for m in CKPT_MODES},
            "in_bytes": sum(len(f) for f in frames), "out_bytes": out_bytes,
            "plain_s": plain_s, "native_s": float(np.mean(native_s)),
            "plain_mbs": out_bytes / plain_s / 1e6,
            "native_mbs": out_bytes / float(np.mean(native_s)) / 1e6}


def ckpt_restores(dev, tmp, hashes):
    """18b: each fixture restored for the card, every leaf's sha256 the
    recorded one, through the native decoder (its calls counted); 18e:
    restore ms of each decoder, CKPT_ROUNDS in turns."""
    from singa_tpu_torch import CheckpointManager
    from singa_tpu_torch.ops import _kernels
    out = {}
    for name, rec in sorted(hashes.items()):
        ws = ckpt_copy(tmp, name)
        _kernels.reset_launches()
        p, o, step = CheckpointManager(ws, log_fn=lambda m: None,
                                       device=dev).restore()
        calls = dict(_kernels.CALLS)
        assert step == rec["step"], (name, step)
        assert calls["zstd_dec"] > 0 and calls["zstd_dec_crc32c"] > 0, calls
        assert not any(_kernels.LAUNCHES.values()), dict(_kernels.LAUNCHES)
        leaves = ckpt_leaves(p, o)
        ckpt_check(leaves, rec, name)
        ms = in_turns({
            "native": lambda: CheckpointManager(
                ws, log_fn=lambda m: None, device=dev).restore(),
            "plain": lambda: CheckpointManager(
                ws, log_fn=lambda m: None, device="cpu").restore()},
            rounds=CKPT_ROUNDS)
        out[name] = {"ws": ws, "step": step, "calls": calls,
                     "leaves": len(leaves), "params": p,
                     "nbytes": sum(v.nbytes for v in leaves.values()),
                     "ms": ms}
    return out


def ckpt_train_on(dev, tmp, rec):
    """18c: `Trainer.resume` and the CLI's `--resume` (`main(argv)`
    here, tensorstore hidden) on copies of the conv.conf fixture take up
    its orbax step and train on to CKPT_TRAIN_TO with the loss finite,
    writing an orbax step beside the TPU's one (the workspace's newest
    step is orbax), which the port lists and restores: the trainer's
    step to the sha256 of the trainer's own state."""
    from singa_tpu_torch import (CheckpointManager, Trainer,
                                 load_model_config, synthetic_image_batches)
    conf = conf_copy(tmp, MNIST_CONF, "conv_ckpt.conf", [
        ("train_steps: 10000", f"train_steps: 10000\ncheckpoint_frequency: "
                               f"{rec['step']}")])
    from singa_tpu_torch.data import discover_input_shapes
    ws = ckpt_copy(tmp, "conv", "conv_trainer")
    model = load_model_config(conf)
    model.train_steps = CKPT_TRAIN_TO
    losses = []
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 device=dev, log_fn=lambda m: None)
    p, o, step = tr.resume(*tr.init(seed=0), ws)
    assert step == rec["step"], step
    ckpt_check(ckpt_leaves(p, o), rec, "Trainer.resume")
    data = synthetic_image_batches(64, (28, 28), seed=7, stream_seed=8)
    hook = [lambda s, m: losses.append(float(m["loss"]))]
    p, o, _ = tr.run(p, o, (next(data) for _ in range(CKPT_TRAIN_TO - step)),
                     start_step=step, workspace=ws, hooks=hook)
    assert len(losses) == CKPT_TRAIN_TO - step and all(
        math.isfinite(x) for x in losses), losses
    mgr = CheckpointManager(ws, log_fn=lambda m: None, device=dev)
    assert mgr.available_steps() == [step, CKPT_TRAIN_TO], \
        mgr.available_steps()
    ckpt_orbax_step(mgr.dir, CKPT_TRAIN_TO)
    rp, ro, got = mgr.restore()
    assert got == CKPT_TRAIN_TO, got
    mine = ckpt_leaves(p, o)
    ckpt_check(ckpt_leaves(rp, ro), {"leaves": ckpt_digests(mine)},
               "the trainer's orbax step")
    cli_ws = ckpt_copy(tmp, "conv", "conv_cli")
    t0 = time.perf_counter()
    code, text = run_main(["-model_conf", conf, "--synthetic", "--steps",
                           str(CKPT_TRAIN_TO), "--workspace", cli_ws,
                           "--resume"], dev)
    wall = time.perf_counter() - t0
    assert code == 0, text[-3000:]
    expect_in(text, f"resumed from step {step}", "training done")
    done = [ln for ln in text.splitlines() if "training done" in ln][-1]
    cli_loss = float(re.search(r"loss : ([-0-9.eE+naif]+)", done).group(1))
    assert math.isfinite(cli_loss), done
    cli = CheckpointManager(cli_ws, log_fn=lambda m: None, device=dev)
    assert cli.available_steps() == [step, CKPT_TRAIN_TO], \
        cli.available_steps()
    ckpt_orbax_step(cli.dir, CKPT_TRAIN_TO)
    cp, co, got = cli.restore()
    assert got == CKPT_TRAIN_TO, got
    assert all(np.isfinite(v).all() for v in ckpt_leaves(cp, co).values())
    return {"step": step, "losses": losses, "cli_loss": cli_loss,
            "cli_wall": wall, "leaves": len(mine)}


def ckpt_orbax_step(ckpt_dir, step):
    """`step` in `ckpt_dir` is a finished orbax step, with no npz."""
    assert os.path.isfile(os.path.join(ckpt_dir, str(step),
                                       "_CHECKPOINT_METADATA")), step
    assert not os.path.exists(os.path.join(ckpt_dir, f"step_{step}.npz"))


def ckpt_digests(leaves) -> dict:
    """hashes.json's record of each leaf: dtype, shape, sha256."""
    import hashlib
    return {k: {"dtype": v.dtype.str, "shape": list(v.shape),
                "sha256": hashlib.sha256(
                    np.ascontiguousarray(v).tobytes()).hexdigest()}
            for k, v in leaves.items()}


def ckpt_bench(dev, tmp, arrays):
    """18g: the 12-layer bench stack at full width, its f32 params and an
    Adam state (the slots filled from the params, so no leaf is zeros),
    saved as an orbax step into a copy of the conv fixture's workspace
    (its newest step is orbax), then restored by a fresh manager with
    the native decoder: every leaf's sha256 equal to the state in
    memory.  Write and restore ms on the host clock (the write's syncs
    included; the files are warm in the page cache for the restore)."""
    from singa_tpu_torch import CheckpointManager, build_net, \
        params_from_numpy
    from singa_tpu_torch.ops import _kernels
    net = build(BENCH, BENCH["seq_len"])
    p = params_from_numpy(net, {k: arrays[k] for k in net.param_specs},
                          device=dev)
    o = {"history": {k: v * 0.5 for k, v in p.items()},
         "update": {k: v * v for k, v in p.items()}}
    sync(dev)
    want = ckpt_digests(ckpt_leaves(p, o))
    nbytes = sum(v.numel() * v.element_size() for v in p.values()) * 3
    ws = ckpt_copy(tmp, "conv", "bench")
    mgr = CheckpointManager(ws, log_fn=lambda m: None, device=dev)
    t0 = time.perf_counter()
    mgr.save(5, p, o)
    write_s = time.perf_counter() - t0
    ckpt_orbax_step(mgr.dir, 5)
    disk = sum(size for _, size in ckpt_tree(os.path.join(mgr.dir, "5")))
    del p, o
    _kernels.reset_launches()
    t0 = time.perf_counter()
    rp, ro, step = CheckpointManager(ws, log_fn=lambda m: None,
                                     device=dev).restore()
    restore_s = time.perf_counter() - t0
    calls = dict(_kernels.CALLS)
    assert step == 5 and (calls["zstd_dec"] > 0 or dev != "cuda"), \
        (step, calls)
    ckpt_check(ckpt_leaves(rp, ro), {"leaves": want}, "the bench stack")
    return {"leaves": len(want), "nbytes": nbytes, "disk": disk,
            "write_ms": write_s * 1e3, "restore_ms": restore_s * 1e3,
            "write_mbs": nbytes / write_s / 1e6,
            "restore_mbs": nbytes / restore_s / 1e6, "calls": calls}


def ckpt_serve(dev, ws, params):
    """18d: an engine following the lm_tiny fixture's workspace serves
    its step, and its greedy tokens equal those of an engine built from
    the same params (the sha-checked arrays of 18b)."""
    from singa_tpu_torch import Trainer, load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    from singa_tpu_torch.serve import InferenceEngine, ServeSpec
    from singa_tpu_torch.weights import params_from_numpy
    model = load_model_config(CKPT_LM_CONF)
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 device=dev, log_fn=lambda m: None)
    net = tr.test_net or tr.train_net
    spec = ServeSpec.parse(f"buckets={CKPT_PROMPTS}x16,max_new_tokens=8")
    served = InferenceEngine(net, spec, net.init_params(0, device=dev),
                             device=dev, workspace=ws,
                             log_fn=lambda m: None)
    step = served.load()
    built = InferenceEngine(net, spec, params_from_numpy(
        net, {k: np.asarray(v) for k, v in params.items()}, device=dev),
        device=dev, log_fn=lambda m: None)
    rng = np.random.default_rng(18)
    prompts = rng.integers(3, 64, (CKPT_PROMPTS, 16)).astype(np.int32)
    lens = np.array([16, 9][:CKPT_PROMPTS], np.int32)
    a = served.run_batch("generate", prompts, lens)
    b = built.run_batch("generate", prompts, lens)
    assert np.array_equal(a, b), (a, b)
    return {"step": step, "tokens": np.asarray(a).tolist(),
            "graphs": (served.graphs, built.graphs)}


def ckpt_tree(ws) -> list:
    """[(path, size)] of every file under `ws`."""
    return sorted((os.path.relpath(os.path.join(d, f), ws),
                   os.path.getsize(os.path.join(d, f)))
                  for d, _, fs in os.walk(ws) for f in fs)


def ckpt_refused_and_torn(dev, tmp, rec):
    """18f: on copies of the conv.conf fixture, (1) a B+tree node
    resealed with format version 3: `restore` and `Trainer.resume`
    raise `OrbaxUnreadableError` naming it, and the CLI's `--resume`
    (`main(argv)` here) returns 1 with the reason, training no step and
    writing nothing;
    (2) a copy of the step as step 8 whose largest leaf's zstd frame
    has the header's reserved bit set: the native decoder's error makes
    step 8 a torn step, and the restore walks back to the older one."""
    import shutil
    from singa_tpu_torch import CheckpointManager, Trainer, load_model_config
    from singa_tpu_torch.data import discover_input_shapes
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.utils import zstd
    from singa_tpu_torch.utils.checkpoint import OrbaxUnreadableError
    from singa_tpu_torch.utils.ocdbt import OcdbtStore
    plain = zstd.Codec(native=False)
    ws = ckpt_copy(tmp, "conv", "conv_unknown")
    top = os.path.join(ws, "checkpoints", str(rec["step"]), "default")
    path, off, length = [e for e in OcdbtStore(top, plain).encoded
                         if not e[0].endswith("manifest.ocdbt")][-1]
    node = os.path.relpath(path, ws)
    with open(path, "r+b") as f:
        f.seek(off)
        data = bytearray(f.read(length))
        data[12] = 3                        # the node's format version
        data[-4:] = zstd.crc32c(bytes(data[:-4])).to_bytes(4, "little")
        f.seek(off)
        f.write(data)
    before = ckpt_tree(ws)
    _kernels.reset_launches()
    try:
        CheckpointManager(ws, log_fn=lambda m: None, device=dev).restore()
    except OrbaxUnreadableError as e:
        msg = str(e)
    else:
        raise AssertionError("restore did not refuse")
    assert "format version 3" in msg, msg
    calls = dict(_kernels.CALLS)
    assert calls["zstd_dec"] > 0, calls
    model = load_model_config(MNIST_CONF)
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 device=dev, log_fn=lambda m: None)
    try:
        tr.resume(*tr.init(seed=0), ws)
    except OrbaxUnreadableError as e:
        assert "format version 3" in str(e), e
    else:
        raise AssertionError("Trainer.resume did not refuse")
    t0 = time.perf_counter()
    code, text = run_main(["-model_conf", MNIST_CONF, "--synthetic",
                           "--steps", str(CKPT_TRAIN_TO), "--workspace", ws,
                           "--resume"], dev)
    wall = time.perf_counter() - t0
    assert code == 1, (code, text[-3000:])
    expect_in(text, "error: ", "format version 3")
    for absent in ("starting from scratch", "training done", "Traceback",
                   "step-"):
        assert absent not in text, (absent, text[-3000:])
    assert ckpt_tree(ws) == before
    # (2) a torn frame in the newest step
    ws = ckpt_copy(tmp, "conv", "conv_torn")
    ckpt = os.path.join(ws, "checkpoints")
    shutil.copytree(os.path.join(ckpt, str(rec["step"])),
                    os.path.join(ckpt, str(CKPT_TRAIN_TO)))
    top = os.path.join(ckpt, str(CKPT_TRAIN_TO), "default")
    (base, rel), off, length = max(
        (v for v in OcdbtStore(top, plain)._all().values()
         if not isinstance(v, bytes)), key=lambda v: v[2])
    with open(os.path.join(top, base, rel), "r+b") as f:
        f.seek(off + 4)
        fhd = f.read(1)[0]
        f.seek(off + 4)
        f.write(bytes([fhd | 0x08]))    # the frame header's reserved bit
    logs = []
    mgr = CheckpointManager(ws, log_fn=logs.append, device=dev)
    assert mgr.available_steps() == [rec["step"], CKPT_TRAIN_TO]
    p, o, step = mgr.restore()
    assert step == rec["step"], step
    ckpt_check(ckpt_leaves(p, o), rec, "walked back")
    warn = [m for m in logs if f"step {CKPT_TRAIN_TO} is corrupt" in m]
    assert warn and "OrbaxTornStepError" in warn[0] \
        and "zstd_dec: error" in warn[0], logs
    return {"msg": msg, "calls": calls, "cli_wall": wall,
            "cli_err": [ln for ln in text.splitlines()
                        if ln.startswith("error: ")][-1],
            "node": node, "warn": warn[0],
            "value": length}


def phase_ckpt(dev, arrays):
    """Phase 18: the JAX package's orbax workspaces (the committed
    fixtures), read on the card with the port's own reader and native
    zstd decoder, tensorstore hidden; the port's orbax steps written
    into them and read back (18c, 18g)."""
    import shutil
    import tempfile
    from singa_tpu_torch.ops import _kernels
    sys.modules["tensorstore"] = None       # as on a machine without it
    hashes = ckpt_hashes()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(REPO, "build"))
    try:
        a = ckpt_decoders(sorted(hashes))
        log(f"[ckpt] 18a native zstd decoder == plain on all {a['frames']} "
            f"frames of the fixtures (manifests, nodes, zarr chunks; "
            f"{a['in_bytes']} bytes -> {a['out_bytes']} bytes) and on the "
            f"{a['corpus']} files of the zstd corpus (each the recorded "
            f"sha256), byte for byte; both raise ZstdError on {a['bad']} "
            f"cut corpus frames; CRC32C native == plain == stored on "
            f"{a['encoded']} encoded files and on every corpus frame")
        log(f"[ckpt] 18a the plain decoder's mode counts over those frames "
            f"(every mode taken): {a['modes']}")
        b = ckpt_restores(dev, tmp, hashes)
        for name, r in sorted(b.items()):
            log(f"[ckpt] 18b CheckpointManager(device={dev!r}) restores the "
                f"{name} fixture's orbax step {r['step']}: {r['leaves']} "
                f"leaves, {r['nbytes']} bytes, each sha256 the recorded "
                f"one; native calls {r['calls']}")
        c = ckpt_train_on(dev, tmp, hashes["conv"])
        log(f"[ckpt] 18c conv.conf fixture: Trainer.resume takes up orbax "
            f"step {c['step']} and trains to {CKPT_TRAIN_TO} (losses "
            f"{[round(x, 6) for x in c['losses']]}), writing orbax step "
            f"{CKPT_TRAIN_TO} beside the TPU's, which the port lists and "
            f"restores with its {c['leaves']} leaves' sha256 those of the "
            f"trainer's state; main()'s --resume (the CLI, in this process) "
            f"likewise writes and restores orbax step {CKPT_TRAIN_TO} "
            f"(final loss {c['cli_loss']}, {c['cli_wall']:.3f} s wall)")
        lm = b["lm_tiny"]
        d = ckpt_serve(dev, lm["ws"], lm["params"])
        log(f"[ckpt] 18d an engine following the lm_tiny fixture serves "
            f"step {d['step']}; greedy tokens equal an engine built from "
            f"the sha-checked params (graphs {d['graphs']}): {d['tokens']}")
        f = ckpt_refused_and_torn(dev, tmp, hashes["conv"])
        log(f"[ckpt] 18f conv.conf fixture with {f['node']} resealed at "
            f"format version 3: restore (native calls {f['calls']}) and "
            f"Trainer.resume raise OrbaxUnreadableError ({f['msg']!r}); "
            f"main()'s --resume returns 1 in {f['cli_wall']:.3f} s wall "
            f"({f['cli_err']!r}), no step trained, nothing written")
        log(f"[ckpt] 18f a copy as step {CKPT_TRAIN_TO} with its largest "
            f"value's ({f['value']} bytes) frame header torn: the restore "
            f"walks back to step {hashes['conv']['step']}, each sha256 the "
            f"recorded one ({f['warn']!r})")
        for name, r in sorted(b.items()):
            ms = r["ms"]
            log(f"[ckpt] 18e restore of the {name} fixture ({r['nbytes']} "
                f"bytes): native {[round(x, 3) for x in ms['native']]} ms, "
                f"plain {[round(x, 3) for x in ms['plain']]} ms "
                f"({CKPT_ROUNDS} rounds in turns; native median "
                f"{float(np.median(ms['native'])):.3f} ms, plain median "
                f"{float(np.median(ms['plain'])):.3f} ms)")
        log(f"[ckpt] 18e decode, one thread, every frame of the fixtures "
            f"({a['out_bytes']} bytes out): native {a['native_mbs']:.1f} "
            f"MB/s ({a['native_s'] * 1e3:.3f} ms, mean of {CKPT_DECODES}), "
            f"plain {a['plain_mbs']:.3f} MB/s ({a['plain_s'] * 1e3:.1f} ms)")
        g = ckpt_bench(dev, tmp, arrays)
        log(f"[ckpt] 18g the bench stack ({BENCH['num_layers']}L, E="
            f"{BENCH['embed_dim']}, V={BENCH['vocab_size']}; f32 params and "
            f"Adam state, {g['leaves']} leaves, {g['nbytes']} bytes) saved "
            f"as an orbax step (zstd frames of Raw blocks) into a copy of "
            f"the conv fixture's workspace: write {g['write_ms']:.1f} ms "
            f"({g['write_mbs']:.1f} MB/s), {g['disk']} bytes on disk; "
            f"restored by a fresh manager with the native decoder "
            f"{g['restore_ms']:.1f} ms ({g['restore_mbs']:.1f} MB/s, the "
            f"files warm in the page cache; native calls {g['calls']}), "
            f"every leaf's sha256 the state's in memory")
        log(f"[ckpt] phase 18's kernel launches: "
            f"{dict(_kernels.LAUNCHES)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 19: training over several processes sharing the card

DP_STEPS = 20           # 19a's CLI runs of conv.conf
DP_TIMED = 20           # 19b's timed steps
DP_LOSS_RTOL = 1e-4
DP_PARAM_RTOL = 1e-4    # of each param's largest magnitude
DRS_STEPS = 77          # mlp.conf: syncs at 60, 68, 76
DRS_ATOL = 1e-6
DIST_WAIT = 600.0
DIST_CHILD = """
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from singa_tpu_torch.parallel.bootstrap import distributed_init
t0 = time.perf_counter()
assert distributed_init(pid, hostfile)
init_s = time.perf_counter() - t0
from singa_tpu_torch import Trainer, load_model_config
from singa_tpu_torch.data import discover_input_shapes, resolve_data_source
from singa_tpu_torch.parallel import comm
def sync():
    if dev == "cuda":
        torch.cuda.synchronize()
# 19b and 19c, one run after another in this one group
for run in json.loads(sys.argv[5]):
    mode, tag, steps = run["mode"], run["tag"], run["steps"]
    model = load_model_config(run["conf"])
    shapes = discover_input_shapes(model, force_synthetic=True)
    bs = next(l for l in model.neuralnet.layer
              if l.type == "kShardData").data_param.batchsize
    res = {"init_s": init_s}
    if mode == "dp":
        from singa_tpu_torch.parallel.mesh import make_mesh
        from singa_tpu_torch.parallel.partition import DataParallel
        dp = DataParallel(make_mesh())
        tr = Trainer(model, shapes, device=dev, log_fn=lambda m: None,
                     dp=dp)
        it = resolve_data_source(model, bs, seed=0, force_synthetic=True)[0]
        batches = [next(it) for _ in range(4)]
        p, o = tr.init(seed=0)
        p, o, m = tr.train_step(p, o, batches[0], 0)
        sync()
        comm.reset_stats()
        t0 = time.perf_counter()
        for s in range(1, steps + 1):
            p, o, m = tr.train_step(p, o, batches[s % 4], s)
        float(m["loss"])
        sync()
        ex = comm.stats(dp.grads)
        res.update(step_ms=(time.perf_counter() - t0) * 1e3 / steps,
                   exchange_ms=ex["seconds"] * 1e3 / ex["calls"],
                   calls=ex["calls"],
                   graphs=tr.graphs, digest=dp.agree(p),
                   nbytes=sum(v.numel() * 4 for v in p.values()))
        # the exchange alone, the card idle: staged (a gradient-sized f32
        # buffer to the host, all-reduced, back), then gloo alone
        n = sum(v.numel() for v in p.values())
        flat, host = torch.ones(n, device=dev), torch.ones(n)
        for name, fn in (("staged_ms", lambda: dp.mean([flat])),
                         ("gloo_ms", lambda: dist.all_reduce(host))):
            fn()
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            sync()
            res[name] = (time.perf_counter() - t0) * 1e3 / 20
    else:
        from singa_tpu_torch.parallel.elastic import DistributedReplicaSet
        tr = Trainer(model, shapes, device=dev, log_fn=lambda m: None)
        drs = DistributedReplicaSet(tr, seed=0)
        it = resolve_data_source(model, bs, seed=0, force_synthetic=True,
                                 stream_seed=1000 * (pid + 1))[0]
        t0 = time.perf_counter()
        center, hist = drs.run(it, steps, seed=0)
        sync()
        res.update(wall_s=time.perf_counter() - t0, graphs=tr.graphs,
                   gather_ms=drs.gather_seconds * 1e3 / max(drs.gathers, 1),
                   gathers=drs.gathers, losses=[h["loss"] for h in hist],
                   poisoned=drs.poisoned_rounds, skipped=drs.skipped_rounds)
        np.savez(f"{out}/center_{tag}_{pid}.npz",
                 **{k: v.cpu().numpy() for k, v in center.items()})
        np.savez(f"{out}/replica_{tag}_{pid}.npz",
                 **{k: v.cpu().numpy() for k, v in drs.params.items()})
    with open(f"{out}/{tag}_{pid}.json", "w") as f:
        json.dump(res, f)
    del tr
    if dev == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def hostfile_of(tmp, name, n):
    """n distinct lines on this machine, the first the coordinator on a
    free port (a duplicate host is refused by `parse_hostfile`)."""
    path = os.path.join(tmp, name)
    lines = [f"127.0.0.1:{free_port()}", "localhost"] + \
        [f"127.0.0.{i}" for i in range(2, n)]
    with open(path, "w") as f:
        f.write("\n".join(lines[:n]) + "\n")
    return path


def run_group(cmds, tmp, tag):
    """Start every command of `cmds` at once (one process each, sharing
    the card); wait for all; return their outputs.  Every process is
    stopped before this returns."""
    env = dict(os.environ, PYTHONPATH=REPO, NVIDIA_TF32_OVERRIDE="0")
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        env.pop(var, None)
    logs = [open(os.path.join(tmp, f"{tag}_{i}.log"), "w+")
            for i in range(len(cmds))]
    t0 = time.time()
    spawned = [spawn(c, f"{tag}[{i}]") for i, c in enumerate(cmds)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=lg,
                              stderr=subprocess.STDOUT, text=True)
             for (c, _), lg in zip(spawned, logs)]
    try:
        for p in procs:
            p.wait(timeout=DIST_WAIT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for p, (_, started) in zip(procs, spawned):
            started(p.returncode)
        log(f"[time] group {tag}: {len(cmds)} processes, "
            f"{time.time() - t0:.2f} s from the first start to the last "
            f"exit")
    outs = []
    for p, lg in zip(procs, logs):
        lg.seek(0)
        outs.append(lg.read())
        lg.close()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], file=sys.stderr)
        assert p.returncode == 0, (tag, i, p.returncode)
    return outs


def display_losses(text):
    return [float(m) for m in re.findall(r"step-\d+: .*?loss : ([-\d.]+)",
                                         text)]


def dist_cli(dev, tmp):
    """19a: conv.conf at its shipped width through `python -m
    singa_tpu_torch.main` with a 2-line hostfile and `data_parallel: 2`,
    against the single-process CLI on the same global batches."""
    from singa_tpu_torch import CheckpointManager
    conf = conf_copy(tmp, MNIST_CONF, "conv_dp.conf",
                     [("display_frequency: 100", "display_frequency: 1")])
    cluster = os.path.join(tmp, "dp2.conf")
    with open(cluster, "w") as f:
        f.write("data_parallel: 2\n")
    hf = hostfile_of(tmp, "hostfile_cli", 2)
    common = ["-model_conf", conf, "--synthetic", "--steps", str(DP_STEPS)]
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + common + [
        "-cluster_conf", cluster, "--workspace", os.path.join(tmp, "ws_dp"),
        "-hostfile", hf, "-procsID", str(i)] for i in range(2)], tmp,
        "cli_dp")
    dp_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = run_one(common + ["--workspace", os.path.join(tmp, "ws_one")],
                     dev, "19a the one-process CLI")
    one_wall = time.perf_counter() - t0
    want = display_losses(single)
    assert len(want) == DP_STEPS, single[-3000:]
    gaps = []
    for out in outs:
        expect_in(out, "mesh: {'data': 2", "training done",
                  "ranks agree")
        got = display_losses(out)
        assert len(got) == DP_STEPS, out[-3000:]
        gaps.append(max(abs(a - b) / abs(b) for a, b in zip(got, want)))
        assert gaps[-1] <= DP_LOSS_RTOL, (got, want)
    digests = [re.search(r"params sha256 (\w+)", o).group(1) for o in outs]
    assert digests[0] == digests[1], digests
    one = CheckpointManager(os.path.join(tmp, "ws_one")).restore()
    two = CheckpointManager(os.path.join(tmp, "ws_dp")).restore()
    assert one[2] == two[2] == DP_STEPS, (one[2], two[2])
    worst = 0.0
    for k, v in one[0].items():
        top = float(np.abs(v).max()) or 1.0
        worst = max(worst, float(np.abs(two[0][k] - v).max()) / top)
    assert worst <= DP_PARAM_RTOL, worst
    exch = re.search(r"(\d+) exchanges, ([\d.]+) ms in all", outs[0])
    return {"dp_wall": dp_wall, "one_wall": one_wall, "loss_gap": max(gaps),
            "param_gap": worst, "digest": digests[0][:16],
            "exchanges": int(exch.group(1)),
            "exchange_ms": float(exch.group(2)) / max(int(exch.group(1)), 1)}


def dist_group(dev, tmp, runs):
    """19b and 19c: one group of 2 processes runs each of `runs` ({mode,
    conf, steps, tag}) in turn; {tag: [each rank's result]} and the
    group's wall time."""
    hf = hostfile_of(tmp, "hostfile_dist", 2)
    child = os.path.join(tmp, "dist_child.py")
    with open(child, "w") as f:
        f.write(DIST_CHILD)
    t0 = time.perf_counter()
    run_group([[sys.executable, child, str(i), hf, tmp, dev,
                json.dumps(runs)] for i in range(2)], tmp, "dist")
    wall = time.perf_counter() - t0
    res = {}
    for run in runs:
        res[run["tag"]] = []
        for i in range(2):
            with open(os.path.join(tmp, f"{run['tag']}_{i}.json")) as f:
                res[run["tag"]].append(json.load(f))
    return res, wall


def single_steps_ms(dev, conf, graphs, n=DP_TIMED):
    """A single-process step of `conf` on the same 4 batches as 19b's
    children, replayed (`graphs` None) or eager."""
    from singa_tpu_torch.data import resolve_data_source
    tr = mlp_trainer(dev, conf, graphs=graphs)
    bs = next(l for l in tr.cfg.neuralnet.layer
              if l.type == "kShardData").data_param.batchsize
    it = resolve_data_source(tr.cfg, bs, seed=0, force_synthetic=True)[0]
    batches = [next(it) for _ in range(4)]
    p, o = tr.init(seed=0)
    p, o, m = tr.train_step(p, o, batches[0], 0)
    sync(dev)
    t0 = time.perf_counter()
    for s in range(1, n + 1):
        p, o, m = tr.train_step(p, o, batches[s % 4], s)
    float(m["loss"])
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n, tr.graphs


def drs_conf(tmp, mlp, param_type):
    return conf_copy(tmp, mlp, f"mlp_{param_type}.conf",
                     [("updater {\n",
                       f'updater {{\n  param_type: "{param_type}"\n')])


def dist_drs(dev, tmp, param_type, steps, conf, res):
    """19c: mlp.conf at its shipped width under `DistributedReplicaSet`
    with 2 processes (`res`, the group's results), against the
    in-process `ReplicaSet` on the card on the same seeds and
    streams."""
    from singa_tpu_torch.parallel.elastic import ReplicaSet
    centers = [dict(np.load(os.path.join(
        tmp, f"center_{param_type}_{i}.npz"))) for i in range(2)]
    reps = [dict(np.load(os.path.join(
        tmp, f"replica_{param_type}_{i}.npz"))) for i in range(2)]
    for k in centers[0]:
        assert np.array_equal(centers[0][k], centers[1][k]), k
    tr = mlp_trainer(dev, conf, ngroups=2)
    rs = ReplicaSet(tr, 2, seed=0)
    iters = [mlp_stream(tr, stream_seed=1000 * (g + 1)) for g in range(2)]
    try:
        center, hist = rs.run(iters, steps, seed=0)
    finally:
        for it in iters:
            it.close()
    gap = max(float(np.abs(centers[0][k] - center[k].cpu().numpy()).max())
              for k in center)
    rgap = max(float(np.abs(reps[g][k] - rs.replicas[g]["params"][k]
                            .cpu().numpy()).max())
               for g in range(2) for k in center)
    equal = gap == 0.0 and rgap == 0.0
    assert gap <= DRS_ATOL and rgap <= DRS_ATOL, (gap, rgap)
    for g in range(2):
        assert res[g]["poisoned"] == 0 and res[g]["skipped"] == 0, res[g]
        np.testing.assert_allclose(res[g]["losses"],
                                   [h["loss"] for h in hist[g]],
                                   rtol=1e-5)
    return {"gap": gap, "rgap": rgap, "equal": equal,
            "gather_ms": [r["gather_ms"] for r in res],
            "gathers": res[0]["gathers"], "graphs": res[0]["graphs"],
            # RandomSync gathers each replica's snapshot beside it
            "nbytes": sum(v.nbytes for v in centers[0].values())
            * (2 if param_type == "RandomSync" else 1),
            "run_s": [r["wall_s"] for r in res]}


def phase_dist(dev, conf=MNIST_CONF, mlp=MLP_CONF, drs_steps=DRS_STEPS):
    """Phase 19; the arguments cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    from singa_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist_", dir=os.path.join(REPO, "build"))
    try:
        a = dist_cli(dev, tmp)
        log(f"[dist] 19a conv.conf (batch 64, shipped width), {DP_STEPS} "
            f"steps through python -m singa_tpu_torch.main: 2 processes "
            f"(-hostfile, data_parallel: 2) in {a['dp_wall']:.3f} s wall "
            f"(process starts included), one process (main(argv) in this "
            f"process) in {a['one_wall']:.3f} s; per-step losses (as the CLI prints them, 6 "
            f"decimals) within {a['loss_gap']:.3g} relative of the "
            f"single-process run's (tol {DP_LOSS_RTOL}); "
            f"final params within {a['param_gap']:.3g} of each param's "
            f"largest magnitude (tol {DP_PARAM_RTOL}); both ranks' params "
            f"equal (sha256 {a['digest']}...); {a['exchanges']} gradient "
            f"exchanges, {a['exchange_ms']:.3f} ms each (host staging "
            f"included)")
        types = ("Elastic", "RandomSync")
        runs = [{"mode": "dp", "conf": conf, "steps": DP_TIMED,
                 "tag": "dp"}] + [
            {"mode": "drs", "conf": drs_conf(tmp, mlp, t),
             "steps": drs_steps, "tag": t} for t in types]
        group, wall = dist_group(dev, tmp, runs)
        res = group["dp"]
        log(f"[dist] 19b/19c one group of 2 processes ran the data-parallel "
            f"steps and both DistributedReplicaSet runs in {wall:.1f} s wall "
            f"(process starts included)")
        replayed, graphs = single_steps_ms(dev, conf, None)
        eager, _ = single_steps_ms(dev, conf, False)
        log(f"[dist] 19b process group start (distributed_init, gloo, "
            f"2 processes): {', '.join(f'{r['init_s'] * 1e3:.1f}' for r in res)} ms")
        log(f"[dist] 19b conv.conf data-parallel step (eager, graphs "
            f"{res[0]['graphs']}), 2 processes on one card: "
            f"{', '.join(f'{r['step_ms']:.3f}' for r in res)} ms, of which "
            f"the gradient exchange (all-reduce of "
            f"{res[0]['nbytes'] / 1e6:.3f} MB through the host) {', '.join(f'{r['exchange_ms']:.3f}' for r in res)}"
            f" ms; one process: {replayed:.3f} ms replayed (graphs "
            f"{graphs}), {eager:.3f} ms eager (batch 64, mean of "
            f"{DP_TIMED})")
        log(f"[dist] 19b the exchange alone, the card idle (20 calls): "
            f"staged through the host "
            f"{', '.join(f'{r['staged_ms']:.3f}' for r in res)} ms, the "
            f"gloo all-reduce of the host buffer alone "
            f"{', '.join(f'{r['gloo_ms']:.3f}' for r in res)} ms")
        assert res[0]["digest"] == res[1]["digest"]
        for param_type, run in zip(types, runs[1:]):
            d = dist_drs(dev, tmp, param_type, drs_steps, run["conf"],
                         group[param_type])
            log(f"[dist] 19c mlp.conf (batch 1000, shipped width) x "
                f"{param_type}, DistributedReplicaSet of 2 processes, "
                f"{drs_steps} steps (graphs {d['graphs']}) in "
                f"{', '.join(f'{s:.3f}' for s in d['run_s'])} s: centers "
                f"equal across the processes; against the in-process "
                f"ReplicaSet max |center gap| {d['gap']:.3g}, max |replica "
                f"gap| {d['rgap']:.3g} (tol {DRS_ATOL}; equal: "
                f"{d['equal']}); {d['gathers']} exchanges of "
                f"{d['nbytes'] / 1e6:.1f} MB a process, all-gathered "
                f"through the host "
                f"{', '.join(f'{x:.3f}' for x in d['gather_ms'])} ms each")
        assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
        log("[dist] phase 19: 0 launches of K1-K6 on these paths")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 20: tensor and sequence parallelism over processes sharing the card

TPSP_STEPS = 5          # 20b/20c steps of the bench stack
# losses against one process's on the same batches (bf16 partial sums
# rounded in another order; measured <= 5.9e-05 on an H100 80GB HBM3)
TPSP_LOSS_RTOL = 3e-4
# ||Δp - Δp_one|| / ||Δp_one||, Δ the params' move from their init: Adam's
# first updates are lr·sign(g), so an element whose gradient rounds
# across zero moves 2·lr apart, while a gradient averaged over the wrong
# ranks moves nearly every element so (a gap near sqrt(2))
TPSP_UPDATE_RTOL = 0.5
CHUNK_CASES = ((8, 6, 512, 64), (8, 12, 512, 64))     # 20a (B, H, S, D)
MESH_STEPS = 3          # 20d
MESH_LAYERS = 2         # 20d's depth cut; the width stays full
LMTP_STEPS = 10         # 20e
LMTP_LOSS_RTOL = 1e-2   # bf16 partial sums and kMoE's top-k on them
CLUSTER_CONF = os.path.join(REPO, "examples", "transformer", "cluster.conf")
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "head_fwd")
TPSP_CHILD = """
import json, sys, time
import torch
import torch.distributed as dist
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
cfg_kw = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                             synthetic_token_batches, transformer_lm)
from singa_tpu_torch.ops import _kernels
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.bootstrap import distributed_init
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import DataParallel
assert distributed_init(pid, hostfile)
# one process's params after the same steps (written by the parent)
one = torch.load(f"{out}/one_params.pt")
data = synthetic_token_batches(cfg_kw["batchsize"], cfg_kw["seq_len"],
                               cfg_kw["vocab_size"], seed=0)
batches = [next(data) for _ in range(cs.TPSP_STEPS)]
shapes = {"data": {"input": (cfg_kw["seq_len"],),
                   "target": (cfg_kw["seq_len"],)}}
arrays, res = None, {}
def sync():
    if dev == "cuda":
        torch.cuda.synchronize()
for run, axes, sp in (("tp", {"model": 2}, "none"),
                      ("ring", {"seq": 2}, "ring"),
                      ("ulysses", {"seq": 2}, "ulysses")):
    dp = DataParallel(make_mesh(**axes))
    tr = Trainer(transformer_lm(**cfg_kw, precision="bfloat16",
                                seq_parallel=sp), shapes, device=dev, dp=dp,
                 log_fn=lambda m: None)
    if arrays is None:
        arrays = numpy_params(tr.train_net, seed=0)
    p = dp.shard_params(params_from_numpy(tr.train_net, arrays, device=dev))
    o = tr.updater.init(p)
    sync()
    dist.barrier()
    _kernels.reset_launches()
    comm.reset_stats()
    losses, times = [], []
    for step, batch in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        sync()
        times.append(time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    n = len(batches)
    layer = [comm.stats(g) for g in (dp.model, dp.seq_group)]
    grad = comm.stats(dp.grads)
    # the gathered params' move from their init against one process's
    whole = dp.gather_params(p)
    num = den = 0.0
    for k, r in one.items():
        p0 = torch.from_numpy(arrays[k]).to(dev)
        want = r.to(dev) - p0
        num += float((whole[k] - p0 - want).square().sum())
        den += float(want.square().sum())
    del whole
    res[run] = dict(
        losses=losses, first_ms=times[0] * 1e3,
        step_ms=sum(times[1:]) * 1e3 / (n - 1),
        layer_ms=sum(x["seconds"] for x in layer) * 1e3 / n,
        layer_mb=sum(x["bytes"] for x in layer) / 1e6 / n,
        layer_calls=sum(x["calls"] for x in layer) / n,
        grad_ms=grad["seconds"] * 1e3 / n, grad_calls=grad["calls"],
        update_gap=(num / den) ** 0.5,
        param_bytes=sum(t.numel() * t.element_size() for t in p.values()),
        opt_bytes=sum(t.numel() * t.element_size()
                      for d in o.values() for t in d.values()),
        launches=launches, digest=dp.agree(p))
    del tr, p, o
    if dev == "cuda":
        torch.cuda.empty_cache()
with open(f"{out}/tpsp_{pid}.json", "w") as f:
    json.dump(res, f)
"""


def check_flash_chunk(b, h, s, d, causal, dev, seed):
    """20a: `flash_chunk` (K1; K3 and K4 in its backward, with the lse
    cotangent folded into delta) against the plain versions on the same
    bf16 inputs; returns the launches it made."""
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k, v = (randn(b, h, s, d).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    w, wl = randn(b, h, s, d), randn(b, h, s, 1)
    before = dict(_kernels.LAUNCHES)
    out, lse = A.flash_chunk(q, k, v, causal)
    torch.autograd.backward([out, lse], [w, wl])
    if dev == "cuda":
        torch.cuda.synchronize()
    made = {n: _kernels.LAUNCHES[n] - before[n] for n in before}
    # the plain versions, step for step as `_FlashPacked` takes them
    packed = [x.detach().reshape(b * h, s, d) for x in (q, k, v)]
    ref_out, ref_lse = A.flash_forward_plain(*packed, 1, causal)
    dout = w.to(torch.bfloat16).reshape(b * h, s, d)
    delta = (dout.float() * ref_out.float()).sum(-1, keepdim=True) \
        - wl.reshape(b * h, s, 1)
    args = (*packed, dout, ref_lse, delta, 1, causal)
    ref = (A.flash_dq_plain(*args), *A.flash_dkv_plain(*args))
    tag = f"b={b} h={h} s={s} d={d} bf16 causal={causal}"
    errs = {"out": (out.detach() - ref_out.float().reshape(out.shape))
            .abs().max().item(),
            "lse": (lse.detach() - ref_lse.reshape(lse.shape)).abs().max()
            .item()}
    # as phases 2 and 5: the forward within 2e-2 and the lse within 1e-3
    # absolute; a bf16 gradient one ulp (2^-8 relative) apart at its
    # largest magnitude (tol 2^-7)
    assert errs["out"] <= 2e-2 and errs["lse"] <= 1e-3, (tag, errs)
    for name, got, want in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                               ref):
        want = want.float().reshape(got.shape)
        top = want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        assert torch.isfinite(got.float()).all(), (tag, name)
        assert err <= 2 ** -7 * top, (tag, name, err, top)
        errs[name] = err
    assert all(made[n] > 0 for n in FLASH_KERNELS[:3]) or dev != "cuda", \
        (tag, made)
    log(f"[tpsp] 20a flash_chunk {tag}, lse cotangent nonzero: "
        + ", ".join(f"max|{n} gap| {e:.3g}" for n, e in errs.items())
        + f"; launches {made}")
    return made


def tpsp_reference(dev, arrays, cfg_kw, tmp, name="one_params.pt"):
    """The single-process eager run of 20b/20c's steps on the same
    batches: losses, step ms and param and optimizer bytes; its final
    params go to `tmp`/`name` for the ranks to compare with."""
    from singa_tpu_torch import Trainer, synthetic_token_batches, \
        transformer_lm
    tr = Trainer(transformer_lm(**cfg_kw, precision="bfloat16"),
                 {"data": {"input": (cfg_kw["seq_len"],),
                           "target": (cfg_kw["seq_len"],)}},
                 device=dev, graphs=False, log_fn=trainer_log)
    p, o = start(tr, arrays, dev)
    data = synthetic_token_batches(cfg_kw["batchsize"], cfg_kw["seq_len"],
                                   cfg_kw["vocab_size"], seed=0)
    losses, times = [], []
    for step in range(TPSP_STEPS):
        batch = next(data)
        sync(dev)
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        sync(dev)
        times.append(time.perf_counter() - t0)
    res = {"losses": losses,
           "step_ms": sum(times[1:]) * 1e3 / (TPSP_STEPS - 1),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in p.values()),
           "opt_bytes": sum(t.numel() * t.element_size()
                            for d in o.values() for t in d.values())}
    torch.save({k: v.cpu() for k, v in p.items()}, os.path.join(tmp, name))
    del tr, p, o
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def tpsp_steps(dev, tmp, arrays, cfg_kw):
    """20b and 20c: one group of 2 processes runs model=2, then seq=2 with
    ring attention, then with Ulysses."""
    child = os.path.join(tmp, "tpsp_child.py")
    with open(child, "w") as f:
        f.write(TPSP_CHILD)
    hf = hostfile_of(tmp, "hostfile_tpsp", 2)
    one = tpsp_reference(dev, arrays, cfg_kw, tmp)
    t0 = time.perf_counter()
    run_group([[sys.executable, child, str(i), hf, tmp, dev,
                json.dumps(cfg_kw)] for i in range(2)], tmp, "tpsp")
    wall = time.perf_counter() - t0
    runs = []
    for i in range(2):
        with open(os.path.join(tmp, f"tpsp_{i}.json")) as f:
            runs.append(json.load(f))
    out = {}
    for run in ("tp", "ring", "ulysses"):
        r = [x[run] for x in runs]
        assert r[0]["digest"] == r[1]["digest"], (run, r)
        gap = max(abs(a - b) / abs(b) for x in r
                  for a, b in zip(x["losses"], one["losses"]))
        assert gap <= TPSP_LOSS_RTOL, (run, [x["losses"] for x in r],
                                       one["losses"])
        assert all(x["update_gap"] <= TPSP_UPDATE_RTOL for x in r), \
            (run, [x["update_gap"] for x in r])
        out[run] = {"gap": gap, "ranks": r}
    return out, one, wall


def tpsp_line(tag, run, res, one, cfg_kw):
    r = res["ranks"]
    axes = "model=2" if run == "tp" else f"seq=2 ({run})"
    log(f"[tpsp] {tag} bench stack ({cfg_kw['num_layers']}L, E="
        f"{cfg_kw['embed_dim']}, {cfg_kw['num_heads']} heads, V="
        f"{cfg_kw['vocab_size']}, S={cfg_kw['seq_len']}, B="
        f"{cfg_kw['batchsize']}, bf16, Adam) under {axes}, 2 processes, "
        f"{TPSP_STEPS} eager steps: losses within {res['gap']:.3g} relative "
        f"of one process's (tol {TPSP_LOSS_RTOL}); ranks' gathered params "
        f"equal (sha256 {r[0]['digest'][:16]}...), their move from the "
        f"init within {r[0]['update_gap']:.3g} relative of one process's "
        f"(tol {TPSP_UPDATE_RTOL}); step "
        f"{', '.join(f'{x['step_ms']:.1f}' for x in r)} ms (first "
        f"{', '.join(f'{x['first_ms']:.1f}' for x in r)} ms) against one "
        f"process's eager {one['step_ms']:.1f} ms; the layers' collectives "
        f"{', '.join(f'{x['layer_ms']:.1f}' for x in r)} ms a step "
        f"({r[0]['layer_calls']:.0f} calls, {r[0]['layer_mb']:.1f} MB sent "
        f"by a rank), the gradient mean "
        f"{', '.join(f'{x['grad_ms']:.1f}' for x in r)} ms a step (host "
        f"staging and the wait for the card included); param bytes "
        f"{', '.join(str(x['param_bytes']) for x in r)} and optimizer bytes "
        f"{', '.join(str(x['opt_bytes']) for x in r)} a rank against one "
        f"process's {one['param_bytes']} and {one['opt_bytes']}; launches "
        f"per rank "
        f"{[{k: x['launches'][k] for k in FLASH_KERNELS} for x in r]}")


def mesh_cli(dev, tmp, cfg_kw):
    """20d: the shipped cluster.conf (2 x 2 x 2) through the CLI on 8
    processes, held to the single-process CLI on the same config; then
    one process resumes the checkpoint rank 0 wrote."""
    from singa_tpu_torch import CheckpointManager, build_net, transformer_lm
    from singa_tpu_torch.config.schema import model_config_to_text
    cfg = transformer_lm(**{**cfg_kw, "num_layers": MESH_LAYERS},
                         precision="bfloat16", seq_parallel="ring")
    cfg.display_frequency = 1
    conf = os.path.join(tmp, "bench_ring.conf")
    with open(conf, "w") as f:
        f.write(model_config_to_text(cfg))
    ws = os.path.join(tmp, "ws_mesh")
    hf = hostfile_of(tmp, "hostfile_mesh", 8)
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + [
        "-model_conf", conf, "-cluster_conf", CLUSTER_CONF, "--synthetic",
        "--steps", str(MESH_STEPS), "--workspace", ws, "-hostfile", hf,
        "-procsID", str(i)] for i in range(8)], tmp, "mesh")
    wall = time.perf_counter() - t0
    digests, losses = set(), set()
    for out in outs:
        expect_in(out, "mesh: {'data': 2, 'model': 2, 'pipe': 1, 'seq': 2, "
                  "'expert': 1}", "training done", "ranks agree")
        digests.add(re.search(r"params sha256 (\w+)", out).group(1))
        got = display_losses(out)
        assert len(got) == MESH_STEPS and all(map(math.isfinite, got)), out
        losses.add(tuple(got))
    assert len(digests) == 1 and len(losses) == 1, (digests, losses)
    losses_of = next(iter(losses))
    rp, ro, step = CheckpointManager(ws).restore()
    assert step == MESH_STEPS, step
    net = build_net(cfg, "kTrain", {"data": {"input": (cfg_kw["seq_len"],),
                                             "target": (cfg_kw["seq_len"],)}})
    for k, spec in net.param_specs.items():
        assert rp[k].shape == spec.shape, (k, rp[k].shape, spec.shape)
    # the same config, batches and init on one process: the mesh's losses
    # and its params' move from the init (the CLI's, seed 0) against it
    ws_one = os.path.join(tmp, "ws_mesh_one")
    one = run_one(["-model_conf", conf, "--synthetic", "--steps",
                   str(MESH_STEPS), "--workspace", ws_one], dev,
                  "20d the one-process CLI")
    want = display_losses(one)
    assert len(want) == MESH_STEPS, one[-3000:]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_of, want))
    assert loss_gap <= TPSP_LOSS_RTOL, (losses_of, want)
    op, _, step = CheckpointManager(ws_one).restore()
    assert step == MESH_STEPS, step
    init = net.init_params(0, device=dev)
    num = den = 0.0
    for k, p0 in init.items():
        move = torch.as_tensor(op[k], device=dev) - p0
        num += float((torch.as_tensor(rp[k], device=dev) - p0 - move)
                     .square().sum())
        den += float(move.square().sum())
    update_gap = (num / den) ** 0.5
    assert update_gap <= TPSP_UPDATE_RTOL, update_gap
    del op, init
    t1 = time.perf_counter()
    code, text = run_main(["-model_conf", conf, "--synthetic", "--steps",
                           str(MESH_STEPS + 2), "--workspace", ws,
                           "--resume"], dev)
    resume_s = time.perf_counter() - t1
    assert code == 0, text[-3000:]
    expect_in(text, f"resumed from step {MESH_STEPS}", "training done")
    assert CheckpointManager(ws).latest_step() == MESH_STEPS + 2
    return {"wall": wall, "digest": digests.pop(), "losses": losses_of,
            "want": want, "loss_gap": loss_gap, "update_gap": update_gap,
            "resume_s": resume_s, "resumed": display_losses(text)}


def lm_tp(dev, tmp, extra=()):
    """20e: lm.conf under tensor_parallel: 2 through the CLI on 2
    processes against the single-process CLI."""
    conf = conf_copy(tmp, LM_CONF, "lm_tp.conf",
                     [("display_frequency: 50", "display_frequency: 1")])
    cluster = os.path.join(tmp, "tp2.conf")
    with open(cluster, "w") as f:
        f.write("tensor_parallel: 2\n")
    hf = hostfile_of(tmp, "hostfile_lm", 2)
    common = ["-model_conf", conf, "--synthetic", "--steps",
              str(LMTP_STEPS), *extra]
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + common + [
        "-cluster_conf", cluster, "-hostfile", hf, "-procsID", str(i)]
        for i in range(2)], tmp, "lm_tp")
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = run_one(common, dev, "20e the one-process CLI")
    one_wall = time.perf_counter() - t0
    want = display_losses(one)
    assert len(want) == LMTP_STEPS, one[-3000:]
    gaps = []
    for out in outs:
        expect_in(out, "mesh: {'data': 1, 'model': 2", "training done",
                  "ranks agree")
        got = display_losses(out)
        assert len(got) == LMTP_STEPS, out[-3000:]
        gaps.append(max(abs(a - b) / abs(b) for a, b in zip(got, want)))
    assert max(gaps) <= LMTP_LOSS_RTOL, (gaps, want)
    return {"wall": wall, "one_wall": one_wall, "gap": max(gaps),
            "losses": display_losses(outs[0]), "want": want}


def phase_tpsp(dev, arrays, cfg_kw=BENCH, chunk_cases=CHUNK_CASES,
               lm_extra=()):
    """Phase 20; the arguments cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile
    from singa_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    for i, (b, h, s, d) in enumerate(chunk_cases):
        for causal in (True, False):
            check_flash_chunk(b, h, s, d, causal, dev, 200 + 2 * i + causal)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tpsp_", dir=os.path.join(REPO, "build"))
    try:
        res, one, wall = tpsp_steps(dev, tmp, arrays, cfg_kw)
        log(f"[tpsp] 20b/20c one group of 2 processes ran the three in "
            f"{wall:.1f} s wall (process starts included)")
        tpsp_line("20b", "tp", res["tp"], one, cfg_kw)
        tpsp_line("20c", "ring", res["ring"], one, cfg_kw)
        tpsp_line("20c", "ulysses", res["ulysses"], one, cfg_kw)
        if dev == "cuda":
            for run in ("tp", "ring", "ulysses"):
                for x in res[run]["ranks"]:
                    assert all(x["launches"][k] > 0
                               for k in FLASH_KERNELS), (run, x["launches"])
        d = mesh_cli(dev, tmp, cfg_kw)
        log(f"[tpsp] 20d examples/transformer/cluster.conf unedited (data 2 "
            f"x model 2 x seq 2) through python -m singa_tpu_torch.main on "
            f"8 processes: the bench stack's config as text, full width, "
            f"seq_parallel ring, depth cut from {cfg_kw['num_layers']} to "
            f"{MESH_LAYERS} layers; {MESH_STEPS} steps in {d['wall']:.1f} s "
            f"wall (process starts included), losses {d['losses']} equal on "
            f"all 8 ranks, params sha256 {d['digest'][:16]}... on all 8; "
            f"against one process's CLI on the same config: losses "
            f"{d['want']}, within {d['loss_gap']:.3g} relative (tol "
            f"{TPSP_LOSS_RTOL}), the checkpoint's move from the init within "
            f"{d['update_gap']:.3g} relative (tol {TPSP_UPDATE_RTOL}); "
            f"rank 0's checkpoint (whole, spec-shaped) resumed by one "
            f"process to step {MESH_STEPS + 2} in {d['resume_s']:.1f} s, "
            f"losses {d['resumed']}")
        e = lm_tp(dev, tmp, lm_extra)
        log(f"[tpsp] 20e examples/transformer/lm.conf under "
            f"tensor_parallel: 2 through the CLI, 2 processes, "
            f"{LMTP_STEPS} steps in {e['wall']:.1f} s wall (one process "
            f"{e['one_wall']:.1f} s): losses within {e['gap']:.3g} relative "
            f"of the single-process CLI's (tol {LMTP_LOSS_RTOL}; the "
            f"strided K1/K3/K4 under a seq axis of 1, kMoE whole): "
            f"{e['losses']} "
            f"against {e['want']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 21: pipeline parallelism over processes sharing the card

ALEXP_BATCH = 256       # 21d: AlexNet-CIFAR10's batch, cut from 1024
ALEXP_STEPS = 3
ALEXP_LOSS_RTOL = 1e-4  # f32, TF32 off: microbatched convs sum in another order
ALEXP_UPDATE_RTOL = 1e-2  # kSGD: a lost or doubled gradient part moves O(1)
PIPECLI_STEPS = 3       # 21e
PIPECLI_LAYERS = 2      # 21e's depth cut; the width stays full
STAGE_CHILD = """
import json, sys, time
import torch
import torch.distributed as dist
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
runs = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from singa_tpu_torch import (Trainer, load_model_config, numpy_params,
                             params_from_numpy, synthetic_image_batches,
                             synthetic_token_batches, transformer_lm)
from singa_tpu_torch.ops import _kernels
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.bootstrap import distributed_init
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import DataParallel
# autograd's first backward with output gradients imports sympy (through
# torch.fx's symbolic shapes); imported here, beside the other ranks,
# rather than inside a pipelined step that the other ranks wait on
import torch.fx.experimental.symbolic_shapes
assert distributed_init(pid, hostfile)
def sync():
    if dev == "cuda":
        torch.cuda.synchronize()
res = {}
for run in runs:
    dp = DataParallel(make_mesh(**run["axes"]))
    if run["net"] == "bench":
        kw = run["cfg_kw"]
        cfg = transformer_lm(**kw, precision="bfloat16",
                             pipeline_stages=run["stages"])
        shapes = {"data": {"input": (kw["seq_len"],),
                           "target": (kw["seq_len"],)}}
        data = synthetic_token_batches(kw["batchsize"], kw["seq_len"],
                                       kw["vocab_size"], seed=0)
    else:
        cfg = cs.alexnet_stage_config(run["batch"])
        shapes = cs.RGB_SHAPES
        data = synthetic_image_batches(run["batch"], (3, 32, 32), seed=0,
                                       stream_seed=1)
    batches = [next(data) for _ in range(run["steps"])]
    tr = Trainer(cfg, shapes, device=dev, dp=dp, log_fn=lambda m: None)
    pnet = tr._pipeline_nets[id(tr.train_net)]
    arrays = numpy_params(tr.train_net, seed=0)
    p = dp.shard_params(params_from_numpy(tr.train_net, arrays, device=dev))
    o = tr.updater.init(p)
    sync()
    dist.barrier()
    _kernels.reset_launches()
    comm.reset_stats()
    losses, times = [], []
    for step, batch in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        sync()
        times.append(time.perf_counter() - t0)
        if step == 0:   # the collectives of the steps after the first
            comm.reset_stats()
    launches = dict(_kernels.LAUNCHES)
    n = len(batches) - 1
    shift = comm.stats(dp.pipe, "shift")
    psum = comm.stats(dp.pipe)
    grad = comm.stats(dp.grads)
    one = torch.load(f"{out}/{run['one']}")
    whole = dp.gather_params(p)
    num = den = 0.0
    for k, r in one.items():
        p0 = torch.from_numpy(arrays[k]).to(dev)
        want = r.to(dev) - p0
        num += float((whole[k] - p0 - want).square().sum())
        den += float(want.square().sum())
    del whole
    res[run["tag"]] = dict(
        losses=losses, first_ms=times[0] * 1e3,
        step_ms=sum(times[1:]) * 1e3 / n,
        shift_ms=shift["seconds"] * 1e3 / n,
        shift_mb=shift["bytes"] / 1e6 / n, shift_calls=shift["calls"] / n,
        psum_ms=psum["seconds"] * 1e3 / n, grad_ms=grad["seconds"] * 1e3 / n,
        update_gap=(num / den) ** 0.5, form=type(pnet).__name__,
        held=len(p), param_bytes=sum(t.numel() * t.element_size()
                                     for t in p.values()),
        launches=launches, digest=dp.agree(p))
    del tr, p, o
    if dev == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
with open(f"{out}/pipe_{pid}.json", "w") as f:
    json.dump(res, f)
"""


def alexnet_stage_config(batch):
    """AlexNet-CIFAR10 cut by locationid into 2 stages of different
    shapes, each with its kLRN: conv1-relu1-norm1-pool1 and conv2-relu2-
    norm2-pool2; in f32, the dtype the JAX package's heterogeneous form
    takes for it (its transport carries the staged input's dtype, and
    the rgb layer's output is f32 while bf16 stages produce bf16)."""
    from singa_tpu_torch import load_model_config
    cfg = load_model_config(ALEX_CONF)
    cfg.precision = "float32"
    for layer in cfg.neuralnet.layer:
        if layer.data_param is not None:
            layer.data_param.batchsize = batch
        stage = {"conv1": 1, "relu1": 1, "norm1": 1, "pool1": 1,
                 "conv2": 2, "relu2": 2, "norm2": 2, "pool2": 2}
        layer.locationid = stage.get(layer.name, 0)
    return cfg


def alexnet_stage_reference(dev, tmp, batch):
    """21d's single-process run on the same batches: losses, step ms,
    its final params to `tmp`/alex_one.pt."""
    from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                                 synthetic_image_batches)
    tr = Trainer(alexnet_stage_config(batch), RGB_SHAPES, device=dev,
                 graphs=False, log_fn=trainer_log)
    arrays = numpy_params(tr.train_net, seed=0)
    p = params_from_numpy(tr.train_net, arrays, device=dev)
    o = tr.updater.init(p)
    data = synthetic_image_batches(batch, (3, 32, 32), seed=0,
                                   stream_seed=1)
    losses, times = [], []
    for step in range(ALEXP_STEPS):
        batch = next(data)
        sync(dev)
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        sync(dev)
        times.append(time.perf_counter() - t0)
    torch.save({k: v.cpu() for k, v in p.items()},
               os.path.join(tmp, "alex_one.pt"))
    del tr, p, o
    return {"losses": losses,
            "step_ms": sum(times[1:]) * 1e3 / (ALEXP_STEPS - 1)}


def stage_groups(dev, tmp, arrays, cfg_kw, alex_batch):
    """21a, 21b and 21d in one group of 2 processes, 21c in a group of 4;
    the single-process references first."""
    child = os.path.join(tmp, "pipe_child.py")
    with open(child, "w") as f:
        f.write(STAGE_CHILD)
    one = tpsp_reference(dev, arrays, cfg_kw, tmp)
    alex = alexnet_stage_reference(dev, tmp, alex_batch)
    bench = dict(net="bench", cfg_kw=cfg_kw, steps=TPSP_STEPS,
                 one="one_params.pt")
    two = [dict(bench, tag="21a", axes={"pipe": 2}, stages=2),
           dict(bench, tag="21b", axes={"pipe": 2}, stages=4),
           dict(net="alex", tag="21d", axes={"pipe": 2}, batch=alex_batch,
                steps=ALEXP_STEPS, one="alex_one.pt")]
    four = [dict(bench, tag="21c", axes={"data": 2, "pipe": 2}, stages=2)]
    out, walls = {}, {}
    for runs, n in ((two, 2), (four, 4)):
        hf = hostfile_of(tmp, f"hostfile_pipe{n}", n)
        t0 = time.perf_counter()
        run_group([[sys.executable, child, str(i), hf, tmp, dev,
                    json.dumps(runs)] for i in range(n)], tmp, f"pipe{n}")
        walls[n] = time.perf_counter() - t0
        ranks = []
        for i in range(n):
            with open(os.path.join(tmp, f"pipe_{i}.json")) as f:
                ranks.append(json.load(f))
        for run in runs:
            r = [x[run["tag"]] for x in ranks]
            assert len({x["digest"] for x in r}) == 1, (run["tag"], r)
            ref = alex if run["net"] == "alex" else one
            gap = max(abs(a - b) / abs(b) for x in r
                      for a, b in zip(x["losses"], ref["losses"]))
            tol, utol = ((ALEXP_LOSS_RTOL, ALEXP_UPDATE_RTOL)
                         if run["net"] == "alex"
                         else (TPSP_LOSS_RTOL, TPSP_UPDATE_RTOL))
            assert gap <= tol, (run["tag"], [x["losses"] for x in r],
                                ref["losses"])
            assert all(x["update_gap"] <= utol for x in r), \
                (run["tag"], [x["update_gap"] for x in r])
            out[run["tag"]] = {"gap": gap, "ranks": r, "ref": ref}
    return out, walls


def stage_line(tag, what, res):
    r = res["ranks"]
    log(f"[pipe] {tag} {what}: losses within {res['gap']:.3g} relative of "
        f"one process's ({r[0]['losses']} against {res['ref']['losses']}); "
        f"ranks' params equal (sha256 {r[0]['digest'][:16]}...), their "
        f"move from the init within "
        f"{', '.join(f'{x['update_gap']:.3g}' for x in r)} relative of one "
        f"process's; {r[0]['form']}; params held a rank "
        f"{[x['held'] for x in r]} ({[x['param_bytes'] for x in r]} "
        f"bytes); step {', '.join(f'{x['step_ms']:.1f}' for x in r)} ms "
        f"(first {', '.join(f'{x['first_ms']:.1f}' for x in r)} ms) "
        f"against one process's eager {res['ref']['step_ms']:.1f} ms; the "
        f"pipe shifts {', '.join(f'{x['shift_ms']:.1f}' for x in r)} ms "
        f"and {', '.join(f'{x['shift_mb']:.2f}' for x in r)} MB sent a "
        f"step a rank ({', '.join(f'{x['shift_calls']:.0f}' for x in r)} "
        f"calls), the gradient sum over pipe "
        f"{', '.join(f'{x['psum_ms']:.1f}' for x in r)} ms, the data mean "
        f"{', '.join(f'{x['grad_ms']:.1f}' for x in r)} ms a step after the "
        f"first (host staging and the wait for the card included); "
        f"launches per rank "
        f"{[{k: v for k, v in x['launches'].items() if v} for x in r]}")


def stage_cli(dev, tmp, cfg_kw):
    """21e: a locationid-marked config (the bench stack at full width,
    depth cut, 2 stages) through the CLI with `pipeline_parallel: 2` on
    2 processes, against the one-process CLI on the same config; one
    process resumes rank 0's checkpoint."""
    from singa_tpu_torch import CheckpointManager, build_net, transformer_lm
    from singa_tpu_torch.config.schema import model_config_to_text
    cfg = transformer_lm(**{**cfg_kw, "num_layers": PIPECLI_LAYERS},
                         precision="bfloat16", pipeline_stages=2)
    cfg.display_frequency = 1
    conf = os.path.join(tmp, "bench_pipe.conf")
    with open(conf, "w") as f:
        f.write(model_config_to_text(cfg))
    cluster = os.path.join(tmp, "pipe2.conf")
    with open(cluster, "w") as f:
        f.write("pipeline_parallel: 2\n")
    ws = os.path.join(tmp, "ws_pipe")
    hf = hostfile_of(tmp, "hostfile_pipecli", 2)
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + [
        "-model_conf", conf, "-cluster_conf", cluster, "--synthetic",
        "--steps", str(PIPECLI_STEPS), "--workspace", ws, "-hostfile", hf,
        "-procsID", str(i)] for i in range(2)], tmp, "pipecli")
    wall = time.perf_counter() - t0
    losses, shifts = set(), []
    for out in outs:
        expect_in(out, "mesh: {'data': 1, 'model': 1, 'pipe': 2",
                  "training done", "ranks agree", "pipe shifts:")
        got = display_losses(out)
        assert len(got) == PIPECLI_STEPS and all(map(math.isfinite, got)), \
            out[-3000:]
        losses.add(tuple(got))
        shifts.append(re.search(r"pipe shifts: .*", out).group(0))
    assert len(losses) == 1, losses
    got = next(iter(losses))
    one = run_one(["-model_conf", conf, "--synthetic", "--steps",
                   str(PIPECLI_STEPS)], dev, "21e the one-process CLI")
    want = display_losses(one)
    assert len(want) == PIPECLI_STEPS, one[-3000:]
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert gap <= TPSP_LOSS_RTOL, (got, want)
    rp, _, step = CheckpointManager(ws).restore()
    assert step == PIPECLI_STEPS, step
    net = build_net(cfg, "kTrain", {"data": {"input": (cfg_kw["seq_len"],),
                                             "target": (cfg_kw["seq_len"],)}})
    for k, spec in net.param_specs.items():
        assert rp[k].shape == spec.shape, (k, rp[k].shape, spec.shape)
    t1 = time.perf_counter()
    code, text = run_main(["-model_conf", conf, "--synthetic", "--steps",
                           str(PIPECLI_STEPS + 2), "--workspace", ws,
                           "--resume"], dev)
    resume_s = time.perf_counter() - t1
    assert code == 0, text[-3000:]
    expect_in(text, f"resumed from step {PIPECLI_STEPS}", "training done")
    return {"wall": wall, "losses": got, "want": want, "gap": gap,
            "shifts": shifts, "resume_s": resume_s,
            "resumed": display_losses(text)}


def phase_stages(dev, arrays, cfg_kw=BENCH, alex_batch=ALEXP_BATCH):
    """Phase 21; the arguments cut it down for a rehearsal on the CPU.
    Returns the K1-K6 launches of one rank of each run, by run."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pipe_", dir=os.path.join(REPO, "build"))
    try:
        res, walls = stage_groups(dev, tmp, arrays, cfg_kw, alex_batch)
        log(f"[pipe] 21a-21d: a group of 2 processes ran 21a, 21b and 21d "
            f"in {walls[2]:.1f} s wall, a group of 4 ran 21c in "
            f"{walls[4]:.1f} s (process starts included)")
        stack = (f"bench stack ({cfg_kw['num_layers']}L, E="
                 f"{cfg_kw['embed_dim']}, {cfg_kw['num_heads']} heads, V="
                 f"{cfg_kw['vocab_size']}, S={cfg_kw['seq_len']}, B="
                 f"{cfg_kw['batchsize']}, bf16, Adam, tied head)")
        stage_line("21a", f"{stack}, 2 stages on pipe=2, 4 microbatches, "
                  f"{TPSP_STEPS} eager steps", res["21a"])
        stage_line("21b", f"{stack}, 4 stages on pipe=2 (the circular "
                  f"schedule), {TPSP_STEPS} eager steps", res["21b"])
        stage_line("21c", f"{stack}, 2 stages on data=2 x pipe=2, 4 "
                  f"processes, {TPSP_STEPS} eager steps", res["21c"])
        stage_line("21d", f"AlexNet-CIFAR10 (alexnet.conf, f32, kSGD, batch "
                  f"{alex_batch}) cut into 2 stages of different shapes "
                  f"(conv1-norm1-pool1, conv2-norm2-pool2) on pipe=2, "
                  f"{ALEXP_STEPS} eager steps", res["21d"])
        if dev == "cuda":
            per_micro = cfg_kw["num_layers"] // 2
            for tag in ("21a", "21b", "21c"):
                for i, x in enumerate(res[tag]["ranks"]):
                    got = x["launches"]
                    # forward and the backward's recompute of each cell,
                    # then one K3 and K4 a layer a microbatch
                    n_cells = 4 * TPSP_STEPS * per_micro
                    assert got["flash_fwd"] == 2 * n_cells, (tag, got)
                    assert got["flash_dq"] == got["flash_dkv"] == n_cells, \
                        (tag, got)
                    last = tag == "21c" and i in (1, 3) or \
                        tag != "21c" and i == 1
                    assert got["head_fwd"] == (TPSP_STEPS if last else 0), \
                        (tag, i, got)
            for x in res["21d"]["ranks"]:
                got = x["launches"]
                assert got["lrn_fwd"] == 2 * 4 * ALEXP_STEPS and \
                    got["lrn_bwd"] == 4 * ALEXP_STEPS, got
        e = stage_cli(dev, tmp, cfg_kw)
        log(f"[pipe] 21e a locationid-marked config (the bench stack's, full "
            f"width, depth cut to {PIPECLI_LAYERS} layers, 2 stages) through "
            f"python -m singa_tpu_torch.main with pipeline_parallel: 2 on 2 "
            f"processes: {PIPECLI_STEPS} steps in {e['wall']:.1f} s wall "
            f"(process starts included), losses {e['losses']} on both "
            f"ranks, within {e['gap']:.3g} relative of the one-process "
            f"CLI's {e['want']} (tol {TPSP_LOSS_RTOL}); {e['shifts']}; rank "
            f"0's checkpoint (whole, spec-shaped) resumed by one process to "
            f"step {PIPECLI_STEPS + 2} in {e['resume_s']:.1f} s, losses "
            f"{e['resumed']}")
        return {tag: res[tag]["ranks"][-1]["launches"] for tag in res}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 22: the expert axis and global-token kMoE

MOE_STEPS = 5           # 22b, 22c
MOE_MESH_STEPS = 3      # 22a
MOE_LOSS_RTOL = 2e-3    # the first step's loss: bf16 sums over a half batch
MOE_LOW_CF = 0.5        # a capacity factor at which moe1 drops tokens
MOE_DROP_SLACK = 0.005  # of T·k: one process's own bf16 forward may flip a
                        # few near-tied choices against the ranks'
MOE_CHILD = """
import json, sys, time
import torch
import torch.distributed as dist
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
axes = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from singa_tpu_torch import (Trainer, load_model_config, numpy_params,
                             params_from_numpy, synthetic_token_batches)
from singa_tpu_torch.core.net import token_split
from singa_tpu_torch.ops import _kernels, moe
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.bootstrap import distributed_init
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import DataParallel
assert distributed_init(pid, hostfile)
def sync():
    if dev == "cuda":
        torch.cuda.synchronize()
dp = DataParallel(make_mesh(**axes))
cfg = load_model_config(cs.LM_CONF)
tr = Trainer(cfg, cs.LM_SHAPES, device=dev, dp=dp, log_fn=lambda m: None)
arrays = numpy_params(tr.train_net, seed=0)
p = dp.shard_params(params_from_numpy(tr.train_net, arrays, device=dev))
o = tr.updater.init(p)
data = synthetic_token_batches(8, cs.LM_SEQ, 4096, seed=0)
batches = [next(data) for _ in range(cs.MOE_STEPS)]
# the first step's routing at moe1: the split's kept assignments against
# one process's ranking of the ranks' own inputs, gathered
layer = tr.train_net.layers["moe1"]
with torch.no_grad():
    outs = tr.train_net.apply(p, dp.shard(batches[0]), train=True,
                              compute_dtype=tr.compute_dtype, rng=0, step=0,
                              shard=dp.shard_spec, par=dp)[2]
x = outs["ln1b"].to(tr.compute_dtype)
router = p["moe1/router"].to(tr.compute_dtype)
b, s, e = x.shape
split = token_split(dp, dp.shard_spec)
t = b * s * split.rows * split.cols
probs = torch.softmax(x.reshape(b * s, e).float() @ router.float(), dim=-1)
gate, expert = moe.top_k(probs, layer.k)
whole = comm.gather(x, 0, split.group)
drops = {}
# lm.conf's own capacity factor, and one at which tokens are dropped
for cf in (layer.capacity_factor, cs.MOE_LOW_CF):
    cap = moe.capacity(t, layer.k, layer.n_exp, cf)
    keep, _ = moe.global_routing(expert, (b, s), layer.n_exp, cap, split)
    dropped = int(comm.reduce_sum(
        (~keep).sum().float().reshape(1), split.group).item())
    r = moe.route(whole.reshape(-1, e), router, layer.k, cap)
    drops[str(cf)] = (dropped, int((r.slot == layer.n_exp * cap).sum()))
sync()
dist.barrier()
_kernels.reset_launches()
comm.reset_stats()
losses, times = [], []
for step, batch in enumerate(batches):
    sync()
    t0 = time.perf_counter()
    p, o, m = tr.train_step(p, o, batch, step)
    losses.append(float(m["loss"]))
    sync()
    times.append(time.perf_counter() - t0)
    if step == 0:       # the collectives of the steps after the first
        comm.reset_stats()
n = len(batches) - 1
route = [comm.stats(g) for g in (split.group, dp.expert)]
res = dict(losses=losses, aux=float(m["moe1/aux"]),
           first_ms=times[0] * 1e3,
           step_ms=sum(times[1:]) * 1e3 / n,
           route_ms=sum(x["seconds"] for x in route) * 1e3 / n,
           route_mb=sum(x["bytes"] for x in route) / 1e6 / n,
           route_calls=sum(x["calls"] for x in route) / n,
           grad_ms=comm.stats(dp.grads)["seconds"] * 1e3 / n,
           experts=list(p["moe1/w1"].shape), drops=drops,
           dropped=drops[str(layer.capacity_factor)][0],
           assignments=t * layer.k,
           launches=dict(_kernels.LAUNCHES), digest=dp.agree(p))
with open(f"{out}/moe_{pid}.json", "w") as f:
    json.dump(res, f)
"""


def moe_reference(dev):
    """lm.conf on one process, eager, on 22b/22c's batches: losses, step
    ms and the first step's dropped assignments at moe1."""
    from singa_tpu_torch import (Trainer, load_model_config, numpy_params,
                                 params_from_numpy, synthetic_token_batches)
    from singa_tpu_torch.ops import moe
    tr = Trainer(load_model_config(LM_CONF), LM_SHAPES, device=dev,
                 graphs=False, log_fn=trainer_log)
    arrays = numpy_params(tr.train_net, seed=0)
    p = params_from_numpy(tr.train_net, arrays, device=dev)
    o = tr.updater.init(p)
    data = synthetic_token_batches(8, LM_SEQ, 4096, seed=0)
    batches = [next(data) for _ in range(MOE_STEPS)]
    layer = tr.train_net.layers["moe1"]
    with torch.no_grad():
        outs = tr.train_net.apply(p, batches[0], train=True,
                                  compute_dtype=tr.compute_dtype, rng=0,
                                  step=0)[2]
    x = outs["ln1b"].to(tr.compute_dtype)
    b, s, e = x.shape
    cap = moe.capacity(b * s, layer.k, layer.n_exp, layer.capacity_factor)
    r = moe.route(x.reshape(b * s, e), p["moe1/router"].to(x.dtype),
                  layer.k, cap)
    dropped = int((r.slot == layer.n_exp * cap).sum())
    losses, times = [], []
    for step, batch in enumerate(batches):
        sync(dev)
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        sync(dev)
        times.append(time.perf_counter() - t0)
    del tr, p, o
    return {"losses": losses, "dropped": dropped,
            "step_ms": sum(times[1:]) * 1e3 / (MOE_STEPS - 1)}


def moe_groups(dev, tmp):
    """22b (data=2 x expert=2, 4 processes) and 22c (data=2, 2
    processes) against one process."""
    child = os.path.join(tmp, "moe_child.py")
    with open(child, "w") as f:
        f.write(MOE_CHILD)
    one = moe_reference(dev)
    out = {}
    for tag, axes in (("22b", {"data": 2, "expert": 2}),
                      ("22c", {"data": 2})):
        n = int(np.prod(list(axes.values())))
        hf = hostfile_of(tmp, f"hostfile_moe{n}", n)
        t0 = time.perf_counter()
        run_group([[sys.executable, child, str(i), hf, tmp, dev,
                    json.dumps(axes)] for i in range(n)], tmp, f"moe{n}")
        wall = time.perf_counter() - t0
        ranks = []
        for i in range(n):
            with open(os.path.join(tmp, f"moe_{i}.json")) as f:
                ranks.append(json.load(f))
        assert len({x["digest"] for x in ranks}) == 1, ranks
        for x in ranks:
            # the split's routing is one process's on the same inputs, at
            # lm.conf's capacity factor and at one that drops tokens
            assert all(a == b for a, b in x["drops"].values()), x
            assert x["drops"][str(MOE_LOW_CF)][0] > 0, x
            assert x["experts"][0] == 4 // axes.get("expert", 1), x
        r0 = ranks[0]
        gap = abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        assert gap <= MOE_LOSS_RTOL, (r0["losses"], one["losses"])
        assert abs(r0["dropped"] - one["dropped"]) <= \
            MOE_DROP_SLACK * r0["assignments"], (r0["dropped"], one)
        assert all(map(math.isfinite, r0["losses"])), r0
        out[tag] = {"ranks": ranks, "gap": gap, "wall": wall}
    return out, one


def moe_mesh_cli(dev, tmp):
    """22a: lm.conf under the shipped cluster.conf (data 2 x model 2 x seq
    2) through the CLI on 8 processes, against the one-process CLI."""
    conf = conf_copy(tmp, LM_CONF, "lm_mesh.conf",
                     [("display_frequency: 50", "display_frequency: 1")])
    hf = hostfile_of(tmp, "hostfile_moemesh", 8)
    common = ["-model_conf", conf, "--synthetic", "--steps",
              str(MOE_MESH_STEPS)]
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + common + [
        "-cluster_conf", CLUSTER_CONF, "-hostfile", hf, "-procsID", str(i)]
        for i in range(8)], tmp, "moemesh")
    wall = time.perf_counter() - t0
    one = run_one(common, dev, "22a the one-process CLI")
    want = display_losses(one)
    assert len(want) == MOE_MESH_STEPS, one[-3000:]
    digests, losses = set(), set()
    for out in outs:
        expect_in(out, "mesh: {'data': 2, 'model': 2, 'pipe': 1, 'seq': 2, "
                  "'expert': 1}", "training done", "ranks agree")
        digests.add(re.search(r"params sha256 (\w+)", out).group(1))
        losses.add(tuple(display_losses(out)))
    assert len(digests) == 1 and len(losses) == 1, (digests, losses)
    got = next(iter(losses))
    assert len(got) == MOE_MESH_STEPS, got
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert gap <= LMTP_LOSS_RTOL, (got, want)
    return {"wall": wall, "losses": got, "want": want, "gap": gap}


def phase_moe(dev):
    """Phase 22.  Returns the K1-K6 launches of one rank of 22b."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="moe_", dir=os.path.join(REPO, "build"))
    try:
        a = moe_mesh_cli(dev, tmp)
        log(f"[moe] 22a examples/transformer/lm.conf under the shipped "
            f"cluster.conf (data 2 x model 2 x seq 2, ring attention, kMoE "
            f"over the global tokens of data x seq) through python -m "
            f"singa_tpu_torch.main on 8 processes: {MOE_MESH_STEPS} steps in "
            f"{a['wall']:.1f} s wall (process starts included), losses "
            f"{a['losses']} on all 8 ranks, params equal; within "
            f"{a['gap']:.3g} relative of the one-process CLI's {a['want']} "
            f"(tol {LMTP_LOSS_RTOL})")
        res, one = moe_groups(dev, tmp)
        for tag, what in (("22b", "data=2 x expert=2, 4 processes"),
                          ("22c", "data=2, 2 processes")):
            r = res[tag]["ranks"]
            log(f"[moe] {tag} lm.conf (bf16, Adam, B=8, S=512) under {what}, "
                f"{MOE_STEPS} eager steps in {res[tag]['wall']:.1f} s wall: "
                f"the first step's loss {r[0]['losses'][0]:.6f} against one "
                f"process's {one['losses'][0]:.6f} on the global batch "
                f"({res[tag]['gap']:.3g} relative, tol {MOE_LOSS_RTOL}); moe1 "
                f"dropped {r[0]['dropped']} of {r[0]['assignments']} "
                f"assignments at lm.conf's capacity factor (one process's "
                f"own forward: {one['dropped']}) and "
                f"{r[0]['drops'][str(MOE_LOW_CF)][0]} at {MOE_LOW_CF}, each "
                f"exactly what one process ranking the ranks' gathered "
                f"inputs drops; experts a rank "
                f"{[x['experts'][0] for x in r]} of 4; losses "
                f"{[round(v, 5) for v in r[0]['losses']]} against "
                f"{[round(v, 5) for v in one['losses']]}; ranks' params "
                f"equal (sha256 {r[0]['digest'][:16]}...); step "
                f"{', '.join(f'{x['step_ms']:.1f}' for x in r)} ms (first "
                f"{', '.join(f'{x['first_ms']:.1f}' for x in r)}) against one "
                f"process's eager {one['step_ms']:.1f} ms; the routing's "
                f"collectives {', '.join(f'{x['route_ms']:.1f}' for x in r)} "
                f"ms a step after the first ({r[0]['route_calls']:.0f} calls, "
                f"{r[0]['route_mb']:.3f} MB sent a rank), the gradient mean "
                f"{', '.join(f'{x['grad_ms']:.1f}' for x in r)} ms; launches "
                f"per rank "
                f"{[{k: v for k, v in x['launches'].items() if v} for x in r]}")
        return res["22b"]["ranks"][0]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 23: CD-k over a data axis, a pipe axis beside the model, seq or
# expert axis, and kMoE inside a pipeline stage

CDP_STEPS = 40          # 23a: 20 CD steps of each RBM, rbm1 persistent
CDP_PARAM_ATOL = 1e-5
CDP_RECON_ATOL = 1e-6
CDP_CLI_STEPS = 40
MIXED_STEPS = TPSP_STEPS        # 23b: the bench stack on pipe=2 x model=2
MIXED_SEQ_LAYERS = 2    # 23c's depth cut on pipe=2 x seq=2; the width stays
LMP_STEPS = 3           # 23c on pipe=2 x expert=2 and 23d on data=2 x pipe=2
LMP_LOSS_RTOL = 2e-3    # bf16: the post group's head over 4 rows, not 1 or 2
LMP_STAGES = {n: 1 for n in ("ln0a", "attn0", "res0a", "ln0b", "ffn0",
                             "res0b")}
LMP_STAGES.update({n: 2 for n in ("ln1a", "attn1", "res1a", "ln1b", "moe1",
                                  "res1b")})
CD_CHILD = """
import json, sys, time
import torch
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.bootstrap import distributed_init
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import DataParallel
assert distributed_init(pid, hostfile)
dp = DataParallel(make_mesh(data=2))
res = cs.cd_run(dev, dp)
p = dp.gather_params(res.pop("params"))
res["digest"] = dp.agree(p)
res["grad_ms"] = comm.stats(dp.grads)["seconds"] * 1e3 / cs.CDP_STEPS
res["grad_mb"] = comm.stats(dp.grads)["bytes"] / 1e6 / cs.CDP_STEPS
if pid == 0:
    torch.save({k: v.cpu() for k, v in p.items()}, f"{out}/cd_ranks.pt")
with open(f"{out}/cd_{pid}.json", "w") as f:
    json.dump(res, f)
"""
MIXED_CHILD = """
import json, sys, time
import torch
import torch.distributed as dist
pid, hostfile, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
runs = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                             synthetic_token_batches, transformer_lm)
from singa_tpu_torch.ops import _kernels, moe
from singa_tpu_torch.parallel import comm
from singa_tpu_torch.parallel.bootstrap import distributed_init
from singa_tpu_torch.parallel.mesh import make_mesh
from singa_tpu_torch.parallel.partition import DataParallel
# autograd's first backward with output gradients imports sympy (through
# torch.fx's symbolic shapes); imported here, beside the other ranks,
# rather than inside a pipelined step that the other ranks wait on
import torch.fx.experimental.symbolic_shapes
assert distributed_init(pid, hostfile)
def sync():
    if dev == "cuda":
        torch.cuda.synchronize()
# a stage's kMoE: what it is given and what its routing drops, in the
# first step's forward (the schedule's recompute runs with grad)
cells, real = [], moe.moe_ffn
def moe_ffn(x, params, k=2, capacity_factor=1.25, split=None, experts=None):
    if record[0] and not torch.is_grad_enabled():
        assert split is None and experts is None, (split, experts)
        b, s, e = x.shape
        cap = moe.capacity(b * s, k, params["router"].shape[1],
                           capacity_factor)
        r = moe.route(x.reshape(b * s, e), params["router"], k, cap)
        cells.append(dict(x=x.detach().cpu(), dropped=int(
            (r.slot == params["router"].shape[1] * cap).sum())))
    return real(x, params, k, capacity_factor, split, experts)
moe.moe_ffn = moe_ffn
record = [False]
res = {}
for run in runs:
    dp = DataParallel(make_mesh(**run["axes"]))
    if run["net"] == "bench":
        kw = run["cfg_kw"]
        cfg = transformer_lm(**kw, precision="bfloat16", pipeline_stages=2)
        shapes = {"data": {"input": (kw["seq_len"],),
                           "target": (kw["seq_len"],)}}
        data = synthetic_token_batches(kw["batchsize"], kw["seq_len"],
                                       kw["vocab_size"], seed=0)
    else:
        cfg = cs.lm_staged()
        shapes = cs.LM_SHAPES
        data = synthetic_token_batches(8, cs.LM_SEQ, 4096, seed=0)
    batches = [next(data) for _ in range(run["steps"])]
    tr = Trainer(cfg, shapes, device=dev, dp=dp, log_fn=lambda m: None)
    pnet = tr._pipeline_nets[id(tr.train_net)]
    arrays = numpy_params(tr.train_net, seed=0)
    p = dp.shard_params(params_from_numpy(tr.train_net, arrays, device=dev))
    o = tr.updater.init(p)
    sync()
    dist.barrier()
    _kernels.reset_launches()
    comm.reset_stats()
    losses, times, keys = [], [], set()
    for step, batch in enumerate(batches):
        record[0] = step == 0
        sync()
        t0 = time.perf_counter()
        p, o, m = tr.train_step(p, o, batch, step)
        losses.append(float(m["loss"]))
        keys |= set(m)
        sync()
        times.append(time.perf_counter() - t0)
        if step == 0:   # the collectives of the steps after the first
            comm.reset_stats()
    record[0] = False
    launches = dict(_kernels.LAUNCHES)
    n = len(batches) - 1
    shift = comm.stats(dp.pipe, "shift")
    layer = comm.stats(dp.model)
    one = torch.load(f"{out}/{run['one']}")
    whole = dp.gather_params(p)
    num = den = 0.0
    for k, r in one.items():
        p0 = torch.from_numpy(arrays[k]).to(dev)
        want = r.to(dev) - p0
        num += float((whole[k] - p0 - want).square().sum())
        den += float(want.square().sum())
    del whole
    if cells:
        torch.save([c["x"] for c in cells],
                   f"{out}/cells_{run['tag']}_{pid}.pt")
    res[run["tag"]] = dict(
        losses=losses, first_ms=times[0] * 1e3,
        step_ms=sum(times[1:]) * 1e3 / n, coords=dp.coords,
        shift_ms=shift["seconds"] * 1e3 / n,
        shift_mb=shift["bytes"] / 1e6 / n, shift_calls=shift["calls"] / n,
        model_ms=layer["seconds"] * 1e3 / n, model_mb=layer["bytes"] / 1e6 / n,
        psum_ms=comm.stats(dp.pipe)["seconds"] * 1e3 / n,
        grad_ms=comm.stats(dp.grads)["seconds"] * 1e3 / n,
        update_gap=(num / den) ** 0.5, form=type(pnet).__name__,
        metrics=sorted(keys), cells=[c["dropped"] for c in cells],
        held=len(p), param_bytes=sum(t.numel() * t.element_size()
                                     for t in p.values()),
        launches=launches, digest=dp.agree(p))
    cells.clear()
    del tr, p, o
    if dev == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
with open(f"{out}/mixed_{pid}.json", "w") as f:
    json.dump(res, f)
"""


def cd_config():
    """rbm.conf uncut (784-250-100, batch 64), rbm1 persistent (PCD)."""
    from singa_tpu_torch import load_model_config
    cfg = load_model_config(RBM_CONF)
    cfg.train_steps = CDP_STEPS
    for layer in cfg.neuralnet.layer:
        if layer.name == "rbm1":
            layer.rbm_param.persistent = True
    return cfg


def cd_run(dev, dp=None):
    """23a's CD-k run through `Trainer.run` (eager): each step's recon,
    the step ms after the first, and the params."""
    from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                                 synthetic_image_batches)
    tr = Trainer(cd_config(), {"data": {"pixel": (28, 28), "label": ()}},
                 device=dev, graphs=False, dp=dp, log_fn=lambda m: None)
    p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, seed=0),
                          device=dev)
    if dp is not None:
        p = dp.shard_params(p)
    o = tr.updater.init(p)
    data = synthetic_image_batches(64, seed=3, stream_seed=30)
    recons, stamps = [], []

    def hook(step, m):
        recons.append(m["recon"])
        stamps.append(time.perf_counter())
    p, o, _ = tr.run(p, o, data, hooks=[hook])
    return {"recons": recons, "params": p, "rows": tr._chains[1].shape[0],
            "step_ms": (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)}


def cd_cli(dev, tmp):
    """23a's CLI: rbm.conf under data_parallel: 2 on 2 processes with
    -hostfile, then one process resumes rank 0's checkpoint."""
    from singa_tpu_torch import CheckpointManager
    conf = conf_copy(tmp, RBM_CONF, "rbm_dp.conf",
                     [("display_frequency: 100", "display_frequency: 10")])
    cluster = os.path.join(tmp, "cd_cluster.conf")
    with open(cluster, "w") as f:
        f.write("data_parallel: 2\n")
    ws = os.path.join(tmp, "ws_cd")
    hf = hostfile_of(tmp, "hostfile_cdcli", 2)
    t0 = time.perf_counter()
    outs = run_group([main_cmd(dev) + [
        "-model_conf", conf, "-cluster_conf", cluster, "--synthetic",
        "--steps", str(CDP_CLI_STEPS), "--workspace", ws, "-hostfile", hf,
        "-procsID", str(i)] for i in range(2)], tmp, "cdcli")
    wall = time.perf_counter() - t0
    recons = set()
    for out in outs:
        expect_in(out, "mesh: {'data': 2, 'model': 1", "training done",
                  "ranks agree")
        recons.add(tuple(float(x) for x in re.findall(
            r"cd\[rbm\d\]: recon : ([\d.]+)", out)))
    assert len(recons) == 1, recons
    got = next(iter(recons))
    assert len(got) == CDP_CLI_STEPS // 10 and all(map(math.isfinite, got))
    rp, _, step = CheckpointManager(ws, log_fn=lambda m: None).restore()
    assert step == CDP_CLI_STEPS, step
    assert rp["rbm0/weight"].shape == (784, 250), rp["rbm0/weight"].shape
    assert rp["rbm1/weight"].shape == (250, 100), rp["rbm1/weight"].shape
    t1 = time.perf_counter()
    code, text = run_main(["-model_conf", conf, "--synthetic", "--steps",
                           str(CDP_CLI_STEPS + 10), "--workspace", ws,
                           "--resume"], dev)
    resume_s = time.perf_counter() - t1
    assert code == 0, text[-3000:]
    expect_in(text, f"resumed from step {CDP_CLI_STEPS}", "training done")
    return {"wall": wall, "recons": got, "resume_s": resume_s}


def phase_cd_parallel(dev, tmp):
    """23a: rbm.conf over data=2 against one process on the same batches
    and global uniforms; then the CLI with a resume."""
    one = cd_run(dev)
    child = os.path.join(tmp, "cd_child.py")
    with open(child, "w") as f:
        f.write(CD_CHILD)
    hf = hostfile_of(tmp, "hostfile_cd", 2)
    t0 = time.perf_counter()
    run_group([[sys.executable, child, str(i), hf, tmp, dev]
               for i in range(2)], tmp, "cd")
    wall = time.perf_counter() - t0
    ranks = []
    for i in range(2):
        with open(os.path.join(tmp, f"cd_{i}.json")) as f:
            ranks.append(json.load(f))
    assert ranks[0]["digest"] == ranks[1]["digest"], ranks
    got = torch.load(os.path.join(tmp, "cd_ranks.pt"))
    pgap = max(float((got[k] - one["params"][k].cpu()).abs().max())
               for k in got)
    rgap = max(abs(a - b) for x in ranks
               for a, b in zip(x["recons"], one["recons"]))
    assert len(ranks[0]["recons"]) == CDP_STEPS
    assert pgap <= CDP_PARAM_ATOL and rgap <= CDP_RECON_ATOL, (pgap, rgap)
    assert all(x["rows"] == 32 for x in ranks) and one["rows"] == 64
    log(f"[cdp] 23a examples/mnist/rbm.conf (784-250-100, batch 64, rbm1 "
        f"PCD), {CDP_STEPS} CD steps (20 an RBM) through Trainer.run on "
        f"data=2, 2 processes, in {wall:.1f} s wall (process starts "
        f"included): params within {pgap:.3g} of one process's on the same "
        f"batches and global uniforms (tol {CDP_PARAM_ATOL}), recon within "
        f"{rgap:.3g} at every step (tol {CDP_RECON_ATOL}; first and last "
        f"{ranks[0]['recons'][0]:.6f}, {ranks[0]['recons'][-1]:.6f}); a "
        f"rank's PCD chain holds {ranks[0]['rows']} rows; ranks' params "
        f"equal (sha256 {ranks[0]['digest'][:16]}...); step "
        f"{', '.join(f'{x['step_ms']:.2f}' for x in ranks)} ms against one "
        f"process's eager {one['step_ms']:.2f} ms, the gradient mean "
        f"{', '.join(f'{x['grad_ms']:.2f}' for x in ranks)} ms a step "
        f"({ranks[0]['grad_mb']:.3f} MB sent a rank)")
    del one
    c = cd_cli(dev, tmp)
    log(f"[cdp] 23a rbm.conf through python -m singa_tpu_torch.main with "
        f"data_parallel: 2 and -hostfile on 2 processes: {CDP_CLI_STEPS} "
        f"steps in {c['wall']:.1f} s wall (process starts included), recon "
        f"lines {c['recons']} equal on both ranks; rank 0's checkpoint "
        f"(whole, spec-shaped) resumed by one process to step "
        f"{CDP_CLI_STEPS + 10} in {c['resume_s']:.1f} s")


def lm_staged():
    """lm.conf uncut with its 2 blocks marked as 2 stages (locationid 1
    and 2, in memory): block 1's kMoE sits inside stage 2."""
    from singa_tpu_torch import load_model_config
    cfg = load_model_config(LM_CONF)
    for layer in cfg.neuralnet.layer:
        layer.locationid = LMP_STAGES.get(layer.name, 0)
    return cfg


def lm_cells_reference(dev, tmp, rows, name):
    """One process's lm.conf steps on the same batches where each cell of
    `rows` rows is its own forward (kMoE routes the cell's tokens, its
    capacity sized on them) and no aux term joins the objective: the
    step's loss is the mean of the cells', its gradient the mean of the
    cells' gradients with the router aux coefficient 0.  Returns the
    losses, the drops of each row block's kMoE at the first step, and
    moe1's input of each cell; the params go to `tmp`/`name`."""
    from singa_tpu_torch import (Trainer, numpy_params, params_from_numpy,
                                 synthetic_token_batches)
    from singa_tpu_torch.ops import moe
    tr = Trainer(load_lm(), LM_SHAPES, device=dev, graphs=False,
                 log_fn=trainer_log)
    layer = tr.train_net.layers["moe1"]
    layer.aux_coef = 0.0
    p = params_from_numpy(tr.train_net, numpy_params(tr.train_net, seed=0),
                          device=dev)
    o = tr.updater.init(p)
    data = synthetic_token_batches(8, LM_SEQ, 4096, seed=0)
    losses, drops, xs = [], [], []
    for step in range(LMP_STEPS):
        batch = next(data)
        grads, loss = None, 0.0
        n = 8 // rows
        for c in range(n):
            cell = {"data": {k: v[c * rows:(c + 1) * rows]
                             for k, v in batch["data"].items()}}
            if step == 0:
                with torch.no_grad():
                    x = tr.train_net.apply(
                        p, cell, train=True, compute_dtype=tr.compute_dtype,
                        rng=0, step=0)[2]["ln1b"].to(tr.compute_dtype)
                b, s, e = x.shape
                cap = moe.capacity(b * s, layer.k, layer.n_exp,
                                   layer.capacity_factor)
                r = moe.route(x.reshape(b * s, e),
                              p["moe1/router"].to(x.dtype), layer.k, cap)
                drops.append(int((r.slot == layer.n_exp * cap).sum()))
                xs.append(x.cpu())
            m, g = tr.gradients(p, cell, step)
            g = {k: v if v is not None else torch.zeros_like(p[k])
                 for k, v in g.items()}
            loss += float(m["loss"]) / n
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        grads = {k: v / n for k, v in grads.items()}
        tr.updater.set_step(step, p, tr.multipliers)
        tr.updater.apply(grads, p, o, multipliers=tr.multipliers)
        losses.append(loss)
    torch.save({k: v.cpu() for k, v in p.items()}, os.path.join(tmp, name))
    del tr, p, o
    return {"losses": losses, "drops": drops, "xs": xs}


def load_lm():
    from singa_tpu_torch import load_model_config
    return load_model_config(LM_CONF)


def mixed_groups(dev, tmp, arrays, cfg_kw):
    """23b, 23c and 23d in one group of 4 processes, the single-process
    references first."""
    from singa_tpu_torch import build_net, numpy_params
    child = os.path.join(tmp, "mixed_child.py")
    with open(child, "w") as f:
        f.write(MIXED_CHILD)
    one = tpsp_reference(dev, arrays, cfg_kw, tmp, "one_bench.pt")
    seq_kw = {**cfg_kw, "num_layers": MIXED_SEQ_LAYERS}
    seq_arrays = numpy_params(build(seq_kw, seq_kw["seq_len"]), seed=0)
    one_seq = tpsp_reference(dev, seq_arrays, seq_kw, tmp, "one_seq.pt")
    cells = {tag: lm_cells_reference(dev, tmp, rows, f"one_{tag}.pt")
             for tag, rows in (("23c_expert", 2), ("23d", 1))}
    bench = dict(net="bench", steps=MIXED_STEPS)
    runs = [dict(bench, tag="23b", axes={"pipe": 2, "model": 2},
                 cfg_kw=cfg_kw, one="one_bench.pt"),
            dict(bench, tag="23c_seq", axes={"pipe": 2, "seq": 2},
                 cfg_kw=seq_kw, one="one_seq.pt"),
            dict(net="lm", tag="23c_expert", axes={"pipe": 2, "expert": 2},
                 steps=LMP_STEPS, one="one_23c_expert.pt"),
            dict(net="lm", tag="23d", axes={"data": 2, "pipe": 2},
                 steps=LMP_STEPS, one="one_23d.pt")]
    hf = hostfile_of(tmp, "hostfile_mixed", 4)
    t0 = time.perf_counter()
    run_group([[sys.executable, child, str(i), hf, tmp, dev,
                json.dumps(runs)] for i in range(4)], tmp, "mixed")
    wall = time.perf_counter() - t0
    ranks = []
    for i in range(4):
        with open(os.path.join(tmp, f"mixed_{i}.json")) as f:
            ranks.append(json.load(f))
    refs = {"23b": one, "23c_seq": one_seq, **cells}
    out = {}
    for run in runs:
        tag = run["tag"]
        r = [x[tag] for x in ranks]
        ref = refs[tag]
        assert len({x["digest"] for x in r}) == 1, (tag, r)
        gap = max(abs(a - b) / abs(b) for x in r
                  for a, b in zip(x["losses"], ref["losses"]))
        tol = TPSP_LOSS_RTOL if run["net"] == "bench" else LMP_LOSS_RTOL
        assert gap <= tol, (tag, [x["losses"] for x in r], ref["losses"])
        assert all(x["update_gap"] <= TPSP_UPDATE_RTOL for x in r), \
            (tag, [x["update_gap"] for x in r])
        assert all(not [k for k in x["metrics"] if k.endswith("/aux")]
                   for x in r), (tag, r[0]["metrics"])
        out[tag] = {"gap": gap, "ranks": r, "ref": ref}
    # 23d and 23c: a stage's kMoE dropped what one process drops routing
    # the same cells' tokens alone, on the same tokens
    for tag in cells:
        got, xs = [], []
        for i, x in enumerate(ranks):
            if x[tag]["cells"]:
                c = x[tag]["coords"]
                got.append((c["data"], x[tag]["cells"]))
                xs.append((c["data"], torch.load(os.path.join(
                    tmp, f"cells_{tag}_{i}.pt"))))
        # the cells of the pipe ranks of stage 2, in (data rank, microbatch)
        # order, which is the global rows' order
        by_data = {}
        for d, drops in got:
            assert by_data.setdefault(d, drops) == drops, (tag, got)
        drops = [v for d in sorted(by_data) for v in by_data[d]]
        assert drops == cells[tag]["drops"], (tag, drops,
                                              cells[tag]["drops"])
        seen = {}
        for d, x in xs:
            seen.setdefault(d, x)
        xgap = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip([x for d in sorted(seen) for x in seen[d]],
                       cells[tag]["xs"]))
        out[tag].update(drops=drops, xgap=xgap)
    return out, wall


def mixed_line(tag, what, res):
    r = res["ranks"]
    extra = ""
    if "drops" in res:
        extra = (f"; moe1 in stage 2 dropped {res['drops']} assignments a "
                 f"cell at the first step, each what one process drops "
                 f"routing that cell's tokens alone (their moe1 input within "
                 f"{res['xgap']:.3g}); no '/aux' metric, and the losses are "
                 f"those of an objective without the aux term")
    log(f"[mixed] {tag} {what}: losses within {res['gap']:.3g} relative of "
        f"one process's ({[round(v, 5) for v in r[0]['losses']]} against "
        f"{[round(v, 5) for v in res['ref']['losses']]}); ranks' params "
        f"equal (sha256 {r[0]['digest'][:16]}...), their move from the init "
        f"within {', '.join(f'{x['update_gap']:.3g}' for x in r)} relative "
        f"of one process's; {r[0]['form']}; params held a rank "
        f"{[x['held'] for x in r]} ({[x['param_bytes'] for x in r]} bytes); "
        f"step {', '.join(f'{x['step_ms']:.1f}' for x in r)} ms (first "
        f"{', '.join(f'{x['first_ms']:.1f}' for x in r)} ms); the pipe "
        f"shifts {', '.join(f'{x['shift_ms']:.1f}' for x in r)} ms and "
        f"{', '.join(f'{x['shift_mb']:.2f}' for x in r)} MB sent a step a "
        f"rank, the model axis's collectives (the pre and post groups'; a "
        f"first pipe rank runs only the pre group's) "
        f"{', '.join(f'{x['model_ms']:.1f}' for x in r)} ms and "
        f"{', '.join(f'{x['model_mb']:.1f}' for x in r)} MB, the gradient "
        f"sum over pipe {', '.join(f'{x['psum_ms']:.1f}' for x in r)} ms, "
        f"the data x seq mean {', '.join(f'{x['grad_ms']:.1f}' for x in r)} "
        f"ms a step after the first (host staging and the wait for the card "
        f"included); ranks' coordinates "
        f"{[{a: v for a, v in x['coords'].items() if v} for x in r]}; "
        f"launches per rank "
        f"{[{k: v for k, v in x['launches'].items() if v} for x in r]}"
        + extra)


def phase_mixed(dev, arrays, cfg_kw=BENCH):
    """Phase 23; the arguments cut it down for a rehearsal on the CPU.
    Returns the K1-K6 launches of each rank of 23b."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mixed_", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.perf_counter()
        phase_cd_parallel(dev, tmp)
        cd_s = time.perf_counter() - t0
        res, wall = mixed_groups(dev, tmp, arrays, cfg_kw)
        log(f"[mixed] 23a took {cd_s:.1f} s; one group of 4 processes ran "
            f"23b, 23c and 23d in {wall:.1f} s wall (process starts "
            f"included)")
        stack = (f"bench stack ({cfg_kw['num_layers']}L, E="
                 f"{cfg_kw['embed_dim']}, {cfg_kw['num_heads']} heads, V="
                 f"{cfg_kw['vocab_size']}, S={cfg_kw['seq_len']}, B="
                 f"{cfg_kw['batchsize']}, bf16, Adam, tied head)")
        mixed_line("23b", f"{stack}, 2 stages on pipe=2 x model=2, 4 "
                   f"processes, 4 microbatches, {MIXED_STEPS} eager steps",
                   res["23b"])
        mixed_line("23c", f"the same stack at depth {MIXED_SEQ_LAYERS}, 2 "
                   f"stages on pipe=2 x seq=2, {MIXED_STEPS} eager steps",
                   res["23c_seq"])
        mixed_line("23c", f"examples/transformer/lm.conf (bf16, Adam, B=8, "
                   f"S=512, E=256) with its 2 blocks as 2 stages (block 1's "
                   f"kMoE in stage 2) on pipe=2 x expert=2, {LMP_STEPS} eager "
                   f"steps, against one process whose cells of 2 rows each "
                   f"route alone", res["23c_expert"])
        mixed_line("23d", f"lm.conf's 2 blocks as 2 stages on data=2 x "
                   f"pipe=2, {LMP_STEPS} eager steps, against one process "
                   f"whose cells of 1 row each route alone", res["23d"])
        if dev == "cuda":
            per_rank = cfg_kw["num_layers"] // 2
            for tag, layers, steps in (("23b", per_rank, MIXED_STEPS),
                                       ("23c_seq", MIXED_SEQ_LAYERS // 2,
                                        MIXED_STEPS),
                                       ("23c_expert", 1, LMP_STEPS),
                                       ("23d", 1, LMP_STEPS)):
                for x in res[tag]["ranks"]:
                    got = x["launches"]
                    # each cell's forward and the backward's recompute,
                    # then one K3 and K4 a layer a microbatch
                    n_cells = 4 * steps * layers
                    assert got["flash_fwd"] == 2 * n_cells, (tag, got)
                    assert got["flash_dq"] == got["flash_dkv"] == n_cells, \
                        (tag, got)
                    last = x["coords"]["pipe"] == 1
                    if tag in ("23b", "23c_seq"):
                        assert (got["head_fwd"] > 0) == last, (tag, x)
        return {i: x["launches"] for i, x in enumerate(res["23b"]["ranks"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from singa_tpu_torch import build_net, numpy_params, transformer_lm
    from singa_tpu_torch.ops import _kernels
    from singa_tpu_torch.utils.flops import peak_flops

    # the bounds' bf16 peak is the port's own (utils/flops.py)
    peak = peak_flops(0)
    assert peak is not None, torch.cuda.get_device_name(0)
    PEAK_FLOPS[torch.bfloat16] = peak

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Where the environment sets PYTHONDONTWRITEBYTECODE, every process
    # this script starts compiles torch's Python source anew (3-5 s of
    # each start): the children share one bytecode cache under build/
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(REPO, "build",
                                                     "pycache")
    dev = "cuda"
    global CARD
    smi = card()
    log(f"[card] {smi}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    CARD = smi

    clock = [time.perf_counter()]

    def took(what):
        now = time.perf_counter()
        log(f"[time] {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for fn, usage in ptxas_usage(text):
            log(f"[build] {name}: {fn}: {usage}")
    for name in ("flash_fwd", "head_fwd", "flash_dq", "flash_dkv"):
        counts = sass_hmma(name)
        for fn, n in sorted(counts.items()):
            log(f"[build] {name}: {fn}: {n} HMMA instructions")
        mma = sum(n for fn, n in counts.items() if "_mma_kernel" in fn)
        log(f"[build] {name}: {mma} HMMA instructions in its bf16 "
            f"(tensor-core) body")
        assert mma > 0, (name, counts)
    took("phase 1")

    k1, k2 = phase_kernels(dev)
    took("phase 2")
    net = build(BENCH, BENCH["seq_len"])
    arrays = numpy_params(net, seed=0)
    launches = phase_forward(dev, arrays)
    # the forward went through the kernels: 12 attention layers, 1 head
    assert launches == {"flash_fwd": 12, "head_fwd": 1, "flash_dq": 0,
                        "flash_dkv": 0, "lrn_fwd": 0, "lrn_bwd": 0}, launches
    took("phase 3")
    phase_serve(dev, arrays)
    took("phase 4a")
    phase_cb(dev, arrays)
    took("phase 4b")
    k34 = phase_flash_bwd(dev)
    took("phase 5")
    phase_grads(dev, arrays)
    took("phase 6")
    launches = phase_train(dev, arrays)
    phase_graphs(dev, arrays)
    phase_resume(dev, arrays)
    took("phase 7")
    k56 = phase_lrn(dev)
    took("phase 8")
    launches.update({k: v for k, v in phase_alexnet(dev).items()
                     if k in ("lrn_fwd", "lrn_bwd")})
    took("phase 9")
    phase_lmconf(dev)
    took("phase 10")
    phase_front(dev)
    took("phase 11")
    cli = phase_cli(dev)
    log(f"[cli] phase 12's launches on the CLI paths: {cli}")
    took("phase 12")
    vis = phase_vision(dev)
    log(f"[vision] phase 13's launches on the meanfile CLI path: {vis}")
    took("phase 13")
    mfus = phase_measure(dev, arrays)
    assert set(mfus) == {"bench", "lmconf", "alexnet"}, mfus
    took("phase 14")
    phase_control(dev, arrays)
    took("phase 15")
    pipe = phase_pipeline(dev)
    log(f"[pipe] phase 16's launches on the pipeline path: {pipe}")
    took("phase 16")
    phase_elastic(dev)
    took("phase 17")
    phase_ckpt(dev, arrays)
    took("phase 18")
    phase_dist(dev)
    took("phase 19")
    phase_tpsp(dev, arrays)
    took("phase 20")
    pipe = phase_stages(dev, arrays)
    log(f"[pipe] phase 21's launches on the last pipe rank: {pipe}")
    took("phase 21")
    experts = phase_moe(dev)
    log(f"[moe] phase 22's launches on rank 0 of 22b: {experts}")
    took("phase 22")
    mixed = phase_mixed(dev, arrays)
    log(f"[mixed] phase 23's launches on each rank of 23b: {mixed}")
    took("phase 23")

    ready = [x for _, x in STARTS if x is not None]
    if ready:
        log(f"[time] {len(STARTS)} processes started; each from its start "
            f"to torch, the port and the card's context ready: median "
            f"{float(np.median(ready)):.2f} s, max {max(ready):.2f} s, sum "
            f"{sum(ready):.1f} s")

    kernels = []
    for name, res, replaces in (
            ("flash_fwd", k1, "singa_tpu/ops/attention.py:335"),
            ("head_fwd", k2, "singa_tpu/ops/head_loss.py:35"),
            ("flash_dq", k34["dq"], "singa_tpu/ops/attention.py:418"),
            ("flash_dkv", k34["dkv"], "singa_tpu/ops/attention.py:479"),
            ("lrn_fwd", k56["lrn_fwd"], "singa_tpu/ops/lrn_pallas.py:62"),
            ("lrn_bwd", k56["lrn_bwd"], "singa_tpu/ops/lrn_pallas.py:70")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"singa_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
