"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each raising on failure:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per library (each attention source once per head dim,
   64, 80 and 128), all at once; print ptxas's registers, stack and spills
   of every kernel instance, and fail on a spill;
3. kernels: each of the five kernels against its plain PyTorch version on
   the card at the serving path's shapes (internlm2-1.8b attention: H=16,
   KV=8, D=128; 4 slots; 8192 positions each, as a dense cache or as 512
   pages of 16 tokens from a 2049-page pool through a randomly permuted
   page table; ragged positions including -1 and 8191; the four decode
   kernels -- one chunked kernel, dense and paged -- also at their chunk
   boundaries, positions 255, 256 and 257, and a slot's output alone
   against it in the batch, bitwise; dense split-K at 2, 4 and 8 splits
   against the dense single pass, bitwise (its splits are whole chunks);
   paged prefill chunks of 256 rows at offsets 0 and 3840 and the ragged
   last chunk of a 4200-token prompt, 104 rows at 4096, windows 0, 1024
   and 200), the decode kernel's working CTAs, then device times of the
   kernel, the plain version and one library call (behind a spin kernel,
   so the host's launch work is not in them), and the bound with the flop
   rate it assumes (the many-row kernel's tensor-core rate for the paged
   prefill and flash attention, 3xTF32 for f32);
3q. quantized pools: the three paged kernels on int8 and on fp8 pools
   (phase 3's pools quantized per token and KV head, with f32 scale pools)
   against their plain versions, which dequantize the same values --
   decode T = 1 and 4 and split-K 2 at both position sets, windows 0 and
   1024; prefill chunks of 256 rows at 3840 (windows 0, 1024) and of 104
   at 4096 (windows 0, 200) -- then timed as in phase 3, the library call
   being SDPA on pools dequantized and gathered outside the timed call,
   and the byte bound counting 1-byte values and 4-byte scales;
4. engine, dense cache: internlm2-1.8b at full width (24 layers, seeded
   random f32 weights, f32 cache) served by ``ServeEngine`` in continuous
   mode -- short requests plus one ~4200-token prompt, so the split-K
   autotuner engages -- then a short wave-mode trace; both dense kernels
   must have been launched by the serving run, and one decode step's
   logits through the kernels must match the plain path, and with 2
   splits equal those of the single pass bitwise; one decode tick
   is timed, single pass against split-K, over alternating rounds, and its
   device time is broken down by kernel with ``torch.profiler``;
4b. engine, paged pool (``cache="paged"``, 16-token pages, prefix cache):
   the same model serves a 4200-token prompt A and three short ones, then
   B = A[:4096] + 50 fresh tokens, which must hit the prefix cache; the
   three paged kernels must have been launched and the dense ones not; B
   served alone with the prefix cache off must give the same tokens; one
   paged decode step's and one paged prefill chunk's logits through the
   kernels must match the plain path; a paged decode tick is timed and
   profiled as in phase 4;
4c. engine, quantized pools: phase 4b's trace and checks with
   ``kv_dtype="int8"`` and then ``"fp8"``; the pools must be int8 /
   float8_e4m3fn with f32 scale leaves, and the logits of one decode step
   and one prefill chunk through the kernels must match the plain path on
   the same quantized pools; tokens/s, TTFT, the pool's bytes and its
   pages per GiB against phase 4b's f32 pool are printed, and a decode
   tick is timed and profiled;
4d. the verify block of speculative decode (T = draft_k + 1 = 4 rows per
   slot), sampling and preemption on the same model: #1, #3 and #3q
   (int8) at T = 4, every row bitwise the T = 1 launch at pos + t (pos
   [-1, 1000, 4200, 8188] and [253, 1021, 4093, 8188], the latter across
   the 256-key chunk boundaries; windows 0 and 1024), then #1 and #3
   timed at T = 4 as in phase 3 with their bound and SDPA; the verify
   block's logits (``decode_step_spec(_paged)``) against four sequential
   decode steps, bitwise, on dense, f32 and int8 paged caches; the greedy
   speculative engine (draft_k = 3, n-gram drafter) on three ~1000-token
   repeating prompts and a 4200-token one against the plain engine, equal
   streams, dense, paged f32 and paged int8, its verify ticks launching
   the layout's decode kernel at T = 4 (counted apart), with acceptance,
   tokens per verify tick, tokens/s of both engines and a plain and a
   verify tick timed and profiled; seeded sampling (temperature 0.8, top-k
   50, top-p 0.9): the same requests in other slots, the speculative
   engine, top-k 1 and temperature 0 against greedy, and the card's
   sampler against the CPU's on one logits tensor (bits and uniforms
   bitwise, tokens equal); preemption (``policy="priority"``, a
   high-priority tenant preempting a running one) with streams equal to
   the run without it, dense and paged (no page left in use), and the
   dense checkpoint's bytes and copy times;
3c. whole-sequence kernels: flash attention (B=2, S=4096, H=16, KV=8,
   D=128; causal with window 0 and 1024, not causal at S=1024, one bf16
   case, and S=1000, no multiple of the tiles, causal and not causal with
   window 300) and the SSD chunk (mamba2-1.3b's B=2, NC=16, NH=64, Q=256,
   hp=64, ds=128, G=1, the prefill's B=4, NC=8, a G=2 case, Q=160 with
   ds=96, and zamba2-2.7b's NH=80, ds=64, f32; the first shape in bf16)
   against their plain versions,
   a batch row and a chunk alone against them in the batch, bitwise, then
   timed against the plain version, SDPA (flash attention only) and the
   bound (the SSD chunk's at its route's tensor-core rate, with the
   CUDA-core bound beside it);
5. the attention forward path: internlm2-1.8b's ``make_prefill_step`` on
   2 prompts x 4096 tokens must launch flash attention 24 times; its
   last-row logits must match the plain path and the dense engine's
   chunked prefill of the same prompt; the prefill is timed and profiled;
6. the SSM path: internlm2 is freed and mamba2-1.3b built at full width
   and depth (48 layers, seeded f32 weights); ``make_prefill_step`` on 4
   prompts x 2048 tokens must launch the SSD kernel 48 times, its logits
   must match the plain path, 32 greedy decode steps follow from its
   states; one 128-token prompt's prefill-then-decode logits must match
   the token-fed path the engine runs; ``ServeEngine`` serves mamba2 in
   continuous mode (more requests than slots, a reused slot checked
   against a fresh engine) and in wave mode; the prefill and a decode tick
   are timed and profiled;
3g. kernels at new groupings: #1, #2, #3 and #5 at mixtral's H=32, KV=8
   (G = 4) with T = 1 and T = 4 (the chunked decode kernel's 16-row
   instance) and at qwen3-moe's H=64, KV=4 (G = 16) with T = 1, at both
   position sets and windows 0, 1024 and 4096, against their plain
   versions (G = 16 at T = 4, past the 16-row instance, once in row
   tiles: phase 3r holds it in full); a slot alone against the batch,
   bitwise; #4 (256-row chunks and the ragged 104-row one) and #6
   at both groupings under windows 0, 1024 and 4096; then each timed as
   in phase 3 with its bound and SDPA (rows ``<kernel>_g4``,
   ``..._g4_verify``, ``..._g16``);
7. gemma3-27b at full width, 8 of 62 layers (one group of 5 local + 1
   global layers and the 2-layer remainder; 14 layers until the training
   phase came, cut for the run's time): phase 4's dense continuous
   serving, logits, tick and wave trace; phase 4b's paged trace with a
   prefix hit and the replay with the prefix cache off, logits and tick;
   an int8 paged run (phase 4c's checks); speculative decode, dense and
   paged, equal to the plain engine (phase 4d); one preemption on the
   dense cache; every attention call counted by window (local layers at
   1024, global at 0, in the plan's proportion); phase 5's prefill step
   on 2 x 4096 (one flash launch a layer, logits against the plain path
   and the chunked prefill);
8. MoE: mixtral-8x7b (4 of 32 layers) through phases 4 and 4b (its
   4200-token prompt past the 4096 window), speculative decode dense and
   paged (the 16-row instance on the engine path) and a 1 x 4096 prefill
   step; qwen3-moe-235b-a22b (2 of 94 layers): a 1 x 2048 prefill step,
   phases 4 and 4b, and speculative decode dense and paged (G x T = 64
   rows a KV head in the verify block: the row tiles) equal to the plain
   engine; each prefill prints its MoE drop fraction.  Each model is built
   alone and freed before the next;
3h. kernels at head dims 80 (zamba2's shared block) and 64 (musicgen),
   H = KV = 32: #1, #2 (2, 4 and 8 splits, bitwise the single pass), #3
   and #5 at T = 1 and 4 at both position sets, windows 0 and 1024, f32
   and bf16 caches and pools, int8 and fp8 pools; a slot alone against
   the batch; #4 (256-row chunks at 0 and 3840, the ragged 104-row one)
   on f32, bf16, int8 and fp8 pools and #6 (S=4096 causal, windows 0 and
   1024; S=1000 with window 300; a bf16 case); head dim 96 refused by
   name, 16 rows at head dim 80 (row tiles) against the plain version;
   then each timed as in phase 3 (rows ``<kernel>_d<D>``);
3r. row tiles and groupings that do not divide 64: #1, #2 (2, 4 and 8
   splits, bitwise the single pass), #3, #5 and #3q/#5q (int8, fp8) at
   granite's H=48, KV=1 (T = 1 and 4: 48 and 192 rows a KV head),
   qwen2.5's H=40, KV=8 (T = 1, 4, 8), qwen3-moe's H=64, KV=4 at T = 4 (64
   rows) and H = KV = 32 at head dims 80 (T = 16) and 64 (T = 9, 16), both
   position sets, windows 0 and 1024, f32 and bf16, against the plain
   versions; a slot alone against the batch and each row of a T-row block
   against the T = 1 launch, bitwise; #4 (256-row chunks at 0 and 3840,
   the ragged 104-row one; f32, bf16, int8, fp8) and #6 (S=4096 causal,
   windows 0 and 1024; S=1000 with window 300; a bf16 case) at G = 5 and
   G = 48; then each timed as in phase 3
   (rows ``<kernel>_g48``, ``_g48_verify``, ``_g5``, ``_g5_verify``,
   ``_g16_verify``, ``_int8_g48``, ``decode_attention_d64_t9``; the
   shapes no model phase runs are timed and printed);
9. zamba2-2.7b at full width, 18 of 54 layers (3 of its 9 groups of 6
   mamba2 layers, each followed by the shared attention block): the 2 x
   4096 prefill step must launch #7 18 times and #6 3 times and match the
   plain path; a decode step from its caches in an 8192-position stripe
   at splits 1 and 2 (#1, #2 at head dim 80), bitwise
   equal, against the plain path, then 8 greedy steps; a 128-token
   prompt's prefill-then-decode against the token feed and the engine;
   ``ServeEngine`` continuous (more requests than slots, a reused slot
   against a fresh engine), wave and one preemption; a decode tick of 4
   slots at pos [4300, 300, -1, 4200] timed and profiled, and the prefill
   timed and profiled;
10. musicgen-large at full width, 12 of 48 layers (head dim 64): phases 4
   and 4b, an int8 paged run (phase 4c's checks, the prefill chunk held
   call by call), a 1 x 4096 prefill step, and speculative decode at
   draft_k = 8 (T = 9: two row tiles) on the dense cache, equal to the
   plain engine;
11. granite-20b at full width, 8 of 52 layers (48 query heads on one KV
   head), and
12. qwen2.5-32b at full width, 6 of 64 layers (G = 5; 16 and 12 layers,
   25.5 and 29.6 GB, until the training phase came, cut for the run's
   time): each
   built alone and freed; phase 4's dense serving, logits and tick, the
   wave trace; phase 4b's paged trace with the prefix hit and the replay;
   an int8 paged run; speculative decode (draft_k = 3, replayed streams)
   dense and paged, bitwise the plain engine; one preemption on the dense
   cache; phase 5's 2 x 4096 prefill step through #6;
13. llava-next-mistral-7b at full width, 16 of 32 layers (32/8 heads of
   128; full depth, 28.97 GB of f32 weights, until the training phase
   came, cut for the run's time), built alone and freed: the 1 x 4096
   prefill from embeddings (``params["embed"]["table"][tokens]``, one flash
   attention launch a layer) equal to the token route's logits bitwise and to
   the plain path within LOGIT_TOL, timed and profiled; phase 4's dense
   serving, logits, tick and wave trace; phase 4b's paged trace with the
   prefix hit and the replay;
14. the serving cluster, on internlm2-1.8b at full width, 8 of 24 layers
   (run after phase 5, before phase 6): replicas of 4 slots, 2048
   positions, 256-token chunks; prompts of 200-900 tokens, 24-48 new tokens, greedy and seeded
   sampled (temperature 0.8, top-p 0.9).  (a) ``ClusterRouter`` over 3
   paged f32 replicas, spread and pack: a fault-free run, then the same
   requests under ``CHAOS`` (replica 1 killed mid-decode and rejoined,
   replica 2's heartbeats dropped past the miss threshold, replica 0
   stalled and straggling inside its step, which the watchdog flags);
   streams equal the fault-free run's token for token,
   every pool drains, ``memory_allocated`` after the rejoin within one pool
   of its value before the kill, every ticket counter back at 0.  (b)
   ``DisaggRouter`` prefill=1, decode=2 on f32 and then int8 pools: streams
   bitwise one unified engine's with the same slots, then with the prefill
   replica killed mid-handoff and rejoined; pools drain; each page transfer
   timed with CUDA events (pages, bytes read + written, ms, rate against
   3.35 TB/s).  (c) the dense pair: host snapshots, streams bitwise the
   unified engine's, each snapshot's bytes and copy times.  (d) the
   queue-depth ``Autoscaler`` on a ``DisaggRouter`` under ``BURSTS``
   (burst, idle, burst): decode scales up, then down with a retiring
   replica releasing its requests; streams bitwise the unified engine's;
   the replica-state trace printed.  (e) the launcher as a subprocess,
   ``--replicas 2 --cache paged --fault-schedule 6:kill:1,14:rejoin:1`` on
   the full config: exit 0, every request finished, a recovery;
15. training, which reaches no kernel (the reference trains on its XLA
   route): (a) internlm2-1.8b at full width, 2 of 24 layers, B = 2, S =
   256, the training launcher's knobs: the loss and every leaf's gradient
   on the card against the CPU route from the same params, one AdamW
   step's master, mu and nu on the card against the CPU's from the same
   gradients, ``grad_accum`` 2 against 1 on the card; (b) at full width and depth (24 layers,
   1,699,579,904 parameters), B = 4, S = 2048, ``TRAIN_STEPS`` steps of
   the ``Trainer`` on ``MarkovSynthetic``: loss and grad_norm finite,
   grad_norm > 0, every param leaf changed, no kernel launched; per step
   the host-clock time (synchronized), tokens/s, model FLOP/s (6 N
   tokens) and the peak memory split into params, optimizer state, grads
   and the rest; a step with the stacked layer leaves indexed per layer
   against the default ``unbind``; one step profiled; (c) the model of
   ``examples/train_lm.py`` (94,715,520 parameters): ``run_with_failures``
   with a failure at step 12 and checkpoints every 5 steps resumes from
   step 10 and ends at 20, its history within ``RESUME_RTOL`` of an
   uninterrupted run's (bitwise or not, printed), the checkpoint's bytes
   and the save and restore seconds; (d) the training launcher as a
   subprocess, ``--smoke --steps 30``: exit 0, the loss falls; (e) #6's
   and #7's wrappers refuse an input that requires grad; (f) the dry run
   of (b)'s step: the same step traced once on the meta device at a
   world of one (``launch/roofline.py``'s ``TraceCounter``, no card): its
   counted flops and HBM bytes, the bytes live before the step and the
   peak it adds, and the roofline step time on the H100 constants
   (``core/h100.py``), beside (b)'s measured step and
   ``max_memory_allocated``; the predicted peak within DRY_PEAK_RTOL of
   the measured one, and the measured step no faster than the roofline;
16. sharded serving (``ServeEngine(mesh=...)``, the gather form of
   ``sharding/rules.py``) of internlm2-1.8b at full width, 8 of 24
   layers, on the one card: the unsharded engine first serves 4 requests
   (prompts of 200-900 tokens, 12-20 new tokens, greedy and seeded-sampled; 4
   slots, 2048 positions, 256-token chunks) dense, paged and speculative
   paged (draft_k = 3) and the preemption flood below, runs the logits
   probe (4 prompts of 300 tokens prefilled in chunks, then one decode
   step) and checks whether the products the cut changes (wq, wk, wv,
   w_gate, w_up: 4 rows cut to 2, columns cut in half) keep their bits;
   then worlds of ranks spawned
   over gloo on ``cuda:0`` (``chip_smoke.py --shard-rank``, a file
   rendezvous; rank 0 loads the kernels first; CUDA tensors exchanged as
   they are) serve the same requests: paged at mesh (1, 2); dense, paged
   and speculative paged at (2, 2) (drafts replayed from the unsharded
   paged streams, so that verify blocks run: the n-gram drafter finds no
   repeats in the random weights' output), and at (2, 2) a preemption
   flood on a paged pool (drf-fair, 6 gold requests of 3-19 prompt
   tokens, 2 free ones two ticks later; the unsharded engine serves it
   too) whose resumed chains move to the other data row.  Each rank
   prints its local shapes (heads, KV heads, slots, pages), the launches
   of each kernel and its verify rows (and verify ticks), each kernel
   against its plain version at the shard shape after the run (#1 and #2
   on its stripes; #3, #5 at T = 1 and 4 and #4 on its pools), and its
   tick host and CUDA-event times, labelled as one card shared by the
   ranks.  A rank that fails fails the run; every rank must launch #1
   (dense) and #3 and #4 (paged), the speculative engine's ranks #3 at T
   = 4, and the flood's ranks must preempt and move a chain across data
   rows; the ranks' streams must agree, and each stream is compared with
   the unsharded engine's, a difference
   reported with its first position and the top-2 logit margin there;
   the logits probe must stay within LOGIT_TOL of the unsharded model's
   (bitwise or not, printed).  Then each world trains (its training
   part, the ranks' serving model freed first): internlm2-1.8b at full
   width, 2 of 24 layers, B = 4 x 512 (``MarkovSynthetic``), the
   training launcher's knobs.  The unsharded train step on the card runs
   first in the phase's own process (``grad_accum`` 2, 3 steps) and
   writes its losses, grad norms and params.  At (2, 2):
   ZeRO-2 (``grad_shardings``), ``grad_accum`` 2, 2 steps, then the
   ``Trainer``'s save (the state gathered whole, rank 0 writing it) and
   the int8 compressed all-reduce over the data group on a (8192, 2048)
   CUDA tensor (within 2% of the float mean, the ranks bitwise alike).
   At (1, 2): tensor parallel, ``grad_accum`` 2, 2 steps; a ``Trainer``
   restoring (2, 2)'s checkpoint (elastic: its own blocks, read from the
   memory-mapped arrays) for one more step; a 2-stage
   ``make_pipelined_forward`` at width 2048 against the sequential
   stack; tensor parallel with the sequence-parallel residual
   (``make_shard_fn(sp=True)``: each rank's layers over its half of the
   512 positions), ``grad_accum`` 2, 2 steps.  Every step's loss and grad_norm within
   SHARD_LOSS_RTOL / SHARD_NORM_RTOL of the unsharded step's, every
   param within SHARD_PARAM_ATOL but for at most SHARD_NEAR0_FRAC of a
   leaf (elements whose gradient lies near 0 move by up to 2 lr a step);
   each rank prints its step host ms (ranks time-sliced on one card:
   not a data-parallel speed), its master, mu and nu bytes against the
   unsharded state's (a (2, 2) rank must hold at most half a (1, 2)
   rank's) and ``max_memory_allocated``.  Last, the launcher with
   ``--tp 2`` in a world of 2 on one card must refuse ("needs 2
   devices").

The last lines are the nvidia-smi line, a JSON ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when CUDA is unavailable or anything fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# The card's rates (memory, and each class of flops: the decode kernels on
# the CUDA cores, the many-row kernels and the SSD chunk on the tensor
# cores, 3xTF32 for f32, 2xTF32 against a 1-byte pool) and each kernel's
# work are the port's: ``repro_torch/core/h100.py`` and
# ``repro_torch/kernels/cost.py``, the functions the dry run's meta
# branch records a kernel's work with.
H, KV, D, B, S = 16, 8, 128, 4, 8192
POS = [-1, 1000, 4200, S - 1]
# the decode kernel's chunk boundaries (256 keys): the last key of a
# chunk, the first, the second, beside the row's last position
POS_EDGES = [255, 256, 257, S - 1]
PAGE, N_PAGES = 16, 2049  # the paged engine's default pool: 4 * 512 + 1
MAX_PAGES = S // PAGE
CHUNK = 256  # the engines' prefill chunk
RAGGED = 4200 - 4096  # the last chunk of a 4200-token prompt
# Kernel against plain version.  With these inputs (randn q, k, v) the
# scores have unit spread, so an output is a softmax average over n = 1k-8k
# keys: |out| ~ sqrt(e / n) ~ 0.02-0.05, at most ~0.2; a parked slot's are
# 0.  Leaving out one 32-key tile moves an output by ~9.3 / n rms (1e-3 at
# n = 8192, 9e-3 at n = 1000), so each tolerance stays below that.
# - f32 cache: both sides accumulate in f32 in other orders (tiled online
#   softmax against one full softmax); measured <= 2.7e-7.  The paged
#   prefill and the flash attention multiply on the tensor cores, each f32
#   product as three TF32 products (3xTF32, ~2^-21 relative) summed by the
#   mma's truncating f32 accumulation; measured <= 4.7e-6.  One TF32 product
#   alone (~2^-11) fails this tolerance.
# - bf16 cache: the kernel rounds p to bf16 before the PV product, as the
#   TPU kernel does, where the plain version keeps p in f32; measured
#   2.9e-4 to 3.3e-4 on an H100.  Rounding p on the plain side would not
#   match the kernel, which rounds exp(s - running max) tile by tile.
# - bf16 q (and so a bf16 output): both sides round an f32 result to bf16,
#   and a value next to a rounding boundary may round either way, so one
#   bf16 ulp of the output (<= 2^-7 |out|) is added.
# - paged kernels: the same arithmetic as the dense ones, so the same
#   bounds at the same positions.  A prefill row, though, may attend only a
#   few keys (row t of the chunk at offset 0 sees t + 1), where rounding p
#   to bf16 moves the output by up to 2^-9 * sum_k p_k |v_k| / l per
#   element; with a bf16 pool that bound (doubled), computed by the plain
#   version on |v|, is added to the prefill's tolerance.
# - int8 / fp8 pools: the kernels and the plain versions dequantize the same
#   stored values with the same scales (float(x) * scale, one f32 rounding,
#   bitwise the same values) and keep p in f32, so what differs is the f32
#   summation order, as with an f32 pool.
TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-3, torch.int8: 5e-5,
       torch.float8_e4m3fn: 5e-5}
BF16_ULP = 2.0 ** -7
# Logits after 24 layers: each layer's attention differs by ~1e-6, which
# the residual stream carries through to the unembedding.
LOGIT_TOL = 1e-3
# mamba2, the same prompt by two routes (one chunked-SSD prefill against
# 128 single-token recurrence steps): f32 both ways, the state summed in
# other orders over 48 layers.
SSM_FEED_TOL = 1e-3


def _log(msg):
    print(msg, flush=True)


def _free_device():
    """Collect what the caller dropped (engines sit in reference cycles and
    hold their params) and return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[device] {name}; nvidia-smi: {smi}; "
         f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


def _ptxas_report(log):
    """{kernel: (registers, stack bytes, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` log, names demangled where
    ``c++filt`` is installed."""
    found, cur = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            cur = line.split("Function properties for ")[1].strip()
            found[cur] = [None, 0, 0, 0]
        elif cur and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            found[cur][1:] = nums[:3]
        elif cur and "Used " in line and " registers" in line:
            found[cur][0] = int(line.split("Used ")[1].split()[0])
            cur = None
    names = list(found)
    with contextlib.suppress(OSError):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    return {n.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0]: tuple(v) for n, v in zip(names, found.values())}


_EARLY = {}  # name: a launcher started at the top of main, reaped later
_CHILDREN = []  # every process started by _spawn, killed if left running


def _spawn(cmd, extra_env=None):
    """Start ``cmd`` from the repo root with ``src`` on its path, its
    output in temporary files; ``_reap`` waits for it."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                            text=True, env={**os.environ, **(extra_env or {}),
                                            "PYTHONPATH": str(ROOT / "src")})
    _CHILDREN.append(proc)
    return proc, out, err, time.perf_counter()


def _reap(job, timeout):
    """(the finished process as ``subprocess.run`` returns it, seconds
    since its start); kills it past ``timeout`` seconds from its start."""
    proc, out, err, t0 = job
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    secs = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    res = subprocess.CompletedProcess(proc.args, proc.returncode,
                                      out.read(), err.read())
    out.close()
    err.close()
    return res, secs


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    _log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
         f"(nvcc: {_build.build_seconds})")
    spills = []
    for src, log in sorted(_build.build_logs.items()):
        for kern, (regs, stack, st, ld) in sorted(_ptxas_report(log).items()):
            _log(f"[build] ptxas {src}: {kern}: {regs} registers, {stack} B "
                 f"stack, {st} B spill stores, {ld} B spill loads")
            if st or ld:
                spills.append(kern)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock


def _time_ms(fn, iters=20, warmup=3, queued=True):
    """Median of ``iters`` CUDA-event timings of ``fn``.  ``queued``: a
    ~1 ms spin kernel (``torch.cuda._sleep``) goes ahead of each start
    event, so the host enqueues ``fn`` while the card spins and the events
    see ``fn``'s device time alone (a kernel of tens of microseconds would
    otherwise read the host's launch work).  The engine ticks, which the
    host bounds, are timed with ``queued=False``: host time included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inputs(t, q_dtype, kv_dtype, seed=0, positions=POS):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, t, H, D), generator=g, device="cuda").to(q_dtype)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(kv_dtype)
    return q, k, v, torch.tensor(positions, dtype=torch.int32, device="cuda")


def _check(label, got, want, kv_dtype, p_round=None):
    """Max abs error of ``got`` against ``want``; raises past the tolerance
    of the cache dtype (plus one bf16 ulp of ``want`` for a bf16 output,
    plus ``p_round``, the bound on rounding p to bf16, where given)."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[kv_dtype]
    limit = tol + (BF16_ULP * want.abs() if got.dtype == torch.bfloat16
                   else 0.0)
    extra = " + 2^-7 |want|" if got.dtype == torch.bfloat16 else ""
    if p_round is not None:
        limit = limit + p_round.float()
        extra += " + 2^-8 attn(|v|)"
    worst = float(err.max())
    _log(f"[kernels] {label}: max_abs_err {worst:.3g} (tol {tol}{extra})")
    if not bool((err <= limit).all()):
        raise AssertionError(f"{label} disagrees with its plain version")
    return worst


def _library_call(q, k, v, pos):
    """One PyTorch call computing the same function (GQA heads expanded
    and a boolean mask prepared outside the timed call); row t of a
    T-row q attends keys <= pos + t."""
    qt = q.transpose(1, 2)
    kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    kpos = torch.arange(S, device="cuda")
    qpos = pos[:, None].long() + torch.arange(q.shape[1], device="cuda")
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)


def _bound_ms(q, k, pos, paged=False):
    """Least time for the work these inputs need (``cost.decode_work``,
    (ms, "bytes" or "operations", the rate)): the live K/V prefix of the
    active slots read once (keys up to pos + T - 1 for a T-row q;
    ``paged``: and the page-table entries that map it; a quantized, 1-byte
    pool: and its f32 scale per key and KV head), q read and the output
    written once, against the card's memory rate; and QK + PV flops
    (row t sees pos + t + 1 keys) against its f32 rate (the decode
    kernels run on the CUDA cores)."""
    from repro_torch.kernels import cost

    b, t, h, d = q.shape
    return cost.decode_work(
        b, t, h, d, k.shape[2], S, q.element_size(), k.element_size(),
        pos.tolist(), page_size=PAGE if paged else 0,
        scales=k.element_size() == 1).bound()


def phase_kernels():
    """The dense decode kernels (#1, #2: the chunked decode kernel in its
    dense mode) against their plain versions at both position sets, a
    slot alone against the batch and split-K against the single pass,
    bitwise, then timed at the dense engine's shapes."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.ops import decode_attention_plain

    errs = {"decode_attention": 0.0, "decode_attention_splitk": 0.0}
    cases = [(t, w, qd, kd) for t in (1, 4) for w in (0, 1024)
             for qd, kd in ((torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16))]
    cases.append((1, 0, torch.bfloat16, torch.bfloat16))
    for positions in (POS, POS_EDGES):
        for t, window, qd, kd in cases:
            q, k, v, pos = _inputs(t, qd, kd, positions=positions)
            err = _check(f"decode_attention pos={positions} T={t} "
                         f"window={window} q={qd} cache={kd}",
                         decode_attention_cuda(q, k, v, pos, window=window),
                         decode_attention_plain(q, k, v, pos,
                                                window=window), kd)
            if kd == torch.float32:
                errs["decode_attention"] = max(errs["decode_attention"], err)
        for window, kd in ((0, torch.float32), (1024, torch.float32),
                           (0, torch.bfloat16)):
            q, k, v, pos = _inputs(1, torch.float32, kd, positions=positions)
            one = decode_attention_cuda(q, k, v, pos, window=window)
            for ns in (2, 4, 8):
                got = decode_attention_splitk_cuda(q, k, v, pos,
                                                   window=window,
                                                   num_splits=ns)
                err = _check(
                    f"decode_attention_splitk pos={positions} ns={ns} "
                    f"window={window} cache={kd}", got,
                    decode_attention_plain(q, k, v, pos, window=window,
                                           num_splits=ns), kd)
                if kd == torch.float32:
                    errs["decode_attention_splitk"] = max(
                        errs["decode_attention_splitk"], err)
                same = torch.equal(got, one)
                _log(f"[kernels] decode_attention_splitk pos={positions} "
                     f"ns={ns} window={window} cache={kd}: equals "
                     f"decode_attention bitwise: {same}")
                if not same:
                    raise AssertionError("dense split-K with whole-chunk "
                                         "splits differs from the single "
                                         "pass")

    def dense(t, positions):
        q, k, v, pos = _inputs(t, torch.float32, torch.float32,
                               positions=positions)
        return (q, k, v, pos), (q[3:], k[3:], v[3:], pos[3:])

    _check_slot_alone("decode_attention", dense, decode_attention_cuda,
                      decode_attention_splitk_cuda)
    torch.cuda.synchronize()

    # times at the engine's decode shapes: T = 1, f32 cache, no window; the
    # autotuner gives split-K 2 splits at these positions
    q, k, v, pos = _inputs(1, torch.float32, torch.float32)
    for ns in (1, 2):
        work, grid = _working_ctas(pos, ns, S, 1)
        _log(f"[kernels] dense decode at pos {POS}, {ns} split(s): {work} "
             f"working CTAs of a {grid}-CTA grid")
    bound = _bound_ms(q, k, pos)
    lib_ms = _time_ms(_library_call(q, k, v, pos))
    rows = []
    for name, run, plain, replaces in (
            ("decode_attention",
             lambda: decode_attention_cuda(q, k, v, pos),
             lambda: decode_attention_plain(q, k, v, pos),
             "src/repro/kernels/decode_attention.py:131"),
            ("decode_attention_splitk",
             lambda: decode_attention_splitk_cuda(q, k, v, pos,
                                                  num_splits=2),
             lambda: decode_attention_plain(q, k, v, pos, num_splits=2),
             "src/repro/kernels/decode_attention.py:236")):
        rows.append(_timed_row(
            name, run, plain, lib_ms, bound,
            "src/repro_torch/kernels/csrc/decode_attention.cu", replaces,
            errs[name]))
    return rows


def _paged_inputs(t, q_dtype, kv_dtype, seed=0, chunk=0, positions=POS):
    """q (B, t, H, D) -- or one slot's chunk (1, chunk, H, D) -- random
    pools (N_PAGES, PAGE, KV, D) (the null page too), a (B, MAX_PAGES)
    page table drawn from a random permutation of pages 1..N_PAGES-1 and
    ``positions``; decode rows map only the pages up to each slot's last
    query position, the rest are the null page 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, chunk, H, D) if chunk else (B, t, H, D),
                    generator=g, device="cuda").to(q_dtype)
    k = torch.randn((N_PAGES, PAGE, KV, D), generator=g,
                    device="cuda").to(kv_dtype)
    v = torch.randn((N_PAGES, PAGE, KV, D), generator=g,
                    device="cuda").to(kv_dtype)
    perm = torch.randperm(N_PAGES - 1, generator=g, device="cuda") + 1
    table = perm[:B * MAX_PAGES].reshape(B, MAX_PAGES).to(torch.int32)
    if not chunk:
        for b, p in enumerate(positions):
            mapped = -(-(p + t) // PAGE) if p >= 0 else 0
            table[b, mapped:] = 0
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, table.contiguous(), pos


def _working_ctas(pos, num_splits, max_pages=MAX_PAGES, page_size=PAGE):
    """CTAs of the chunked decode kernel (T = 1, no window) that hold keys
    their slot sees, and the grid's KV x B x chunks; a dense cache is
    ``max_pages`` = S pages of one token."""
    from repro_torch.kernels.decode_attention import decode_chunks

    _, _, ranges = decode_chunks(max_pages, page_size, num_splits)
    work = sum(lo <= p for p in pos.tolist() for lo, hi in ranges if lo < hi)
    return KV * work, KV * len(pos) * len(ranges)


def _check_slot_alone(name, inputs, decode, splitk, ts=(1, 4)):
    """Slot 3's output computed alone equals, bitwise, its output in the
    batch of four, for the single-pass kernel (T in ``ts``) and split-K
    (2 splits), at both position sets.  ``inputs(t, positions)`` gives the
    batch's arguments and slot 3's."""
    for positions in (POS, POS_EDGES):
        for label, t, run in (
                [(name, t, decode) for t in ts]
                + [(f"{name}_splitk ns=2", 1,
                    functools.partial(splitk, num_splits=2))]):
            args, alone_args = inputs(t, positions)
            batch = run(*args)
            alone = run(*alone_args)
            same = torch.equal(alone[0], batch[3])
            _log(f"[kernels] {label} pos={positions} T={t} H={H} KV={KV}: "
                 f"slot 3 alone equals it in the batch bitwise: {same}")
            if not same:
                raise AssertionError(f"a slot's {name} output depends on "
                                     f"the rest of the batch")


def _paged_library_call(q, k, v, table, pos):
    """One SDPA call on the already gathered dense view (the gather is not
    in the timed call), GQA heads expanded, with a boolean mask."""
    kd = k[table.long()].reshape(B, S, KV, D)
    vd = v[table.long()].reshape(B, S, KV, D)
    return _library_call(q, kd, vd, pos)


def _prefill_bound_ms(q, k, q_offset):
    """Least time of one chunk (``cost.prefill_work``): its causal QK + PV
    flops at the many-row kernel's tensor-core rate (``cost.tc_class``)
    against the live K/V prefix (a quantized pool: and its f32 scales),
    its page-table entries, q and the output at the card's memory
    rate."""
    from repro_torch.kernels import cost

    _, c, h, d = q.shape
    return cost.prefill_work(
        c, h, d, k.shape[2], q_offset, q.element_size(), k.element_size(),
        PAGE, cost.tc_class(q, k), scales=k.element_size() == 1).bound()


def _prefill_library_call(q, k, v, row, q_offset):
    """One SDPA call on the slot's gathered prefix [0, q_offset + C) (the
    gather is not in the timed call), with the causal mask at the
    offset."""
    c = q.shape[1]
    n = q_offset + c
    kd = k[row.long()].reshape(1, S, KV, D)[:, :n]
    vd = v[row.long()].reshape(1, S, KV, D)[:, :n]
    qt = q.transpose(1, 2)
    kx = kd.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = vd.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qpos = q_offset + torch.arange(c, device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] <= qpos[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask)


def phase_paged_kernels():
    """The three paged kernels against their plain versions, then timed at
    the paged engine's shapes: T = 1 decode and split-K 2 at the dense
    phase's positions, and a 256-row prefill chunk at offset 3840."""
    from repro_torch.kernels.ops import (paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    errs = {"paged_decode_attention": 0.0,
            "paged_decode_attention_splitk": 0.0,
            "paged_prefill_attention": 0.0}
    for positions in (POS, POS_EDGES):
        for t in (1, 4):
            for window in (0, 1024):
                for kd in (torch.float32, torch.bfloat16):
                    q, k, v, table, pos = _paged_inputs(
                        t, torch.float32, kd, positions=positions)
                    err = _check(
                        f"paged_decode_attention pos={positions} T={t} "
                        f"window={window} pool={kd}",
                        paged_decode_attention_cuda(q, k, v, table, pos,
                                                    window=window),
                        paged_decode_attention_plain(q, k, v, table, pos,
                                                     window=window), kd)
                    if kd == torch.float32:
                        errs["paged_decode_attention"] = max(
                            errs["paged_decode_attention"], err)
        for ns in (2, 4, 8):
            for window, kd in ((0, torch.float32), (1024, torch.float32),
                               (0, torch.bfloat16)):
                q, k, v, table, pos = _paged_inputs(1, torch.float32, kd,
                                                    positions=positions)
                err = _check(
                    f"paged_decode_attention_splitk pos={positions} "
                    f"ns={ns} window={window} pool={kd}",
                    paged_decode_attention_splitk_cuda(
                        q, k, v, table, pos, window=window,
                        num_splits=ns),
                    paged_decode_attention_plain(q, k, v, table, pos,
                                                 window=window,
                                                 num_splits=ns), kd)
                if kd == torch.float32:
                    errs["paged_decode_attention_splitk"] = max(
                        errs["paged_decode_attention_splitk"], err)
    def paged(t, positions):
        q, k, v, table, pos = _paged_inputs(t, torch.float32, torch.float32,
                                            positions=positions)
        return (q, k, v, table, pos), (q[3:], k, v, table[3:], pos[3:])

    _check_slot_alone("paged_decode_attention", paged,
                      paged_decode_attention_cuda,
                      paged_decode_attention_splitk_cuda)
    slot = B - 1  # a fully mapped row
    # full chunks at offsets 0 and 3840 (the latter split over the key
    # range), and the engine's ragged last chunk of a 4200-token prompt
    # (C = 104 at 4096), also under a window shorter than the chunk's span
    prefill_cases = [(CHUNK, q_offset, window)
                     for q_offset in (0, S // 2 - CHUNK)
                     for window in (0, 1024)]
    prefill_cases += [(RAGGED, S // 2, window) for window in (0, 200)]
    for c, q_offset, window in prefill_cases:
        for kd in (torch.float32, torch.bfloat16):
            q, k, v, table, _ = _paged_inputs(1, torch.float32, kd,
                                              chunk=c)
            p_round = None
            if kd == torch.bfloat16:
                p_round = 2.0 ** -8 * paged_prefill_attention_plain(
                    q, k, v.abs(), table, slot, q_offset, window=window)
            err = _check(
                f"paged_prefill_attention C={c} q_offset={q_offset} "
                f"window={window} pool={kd}",
                paged_prefill_attention_cuda(q, k, v, table[slot],
                                             q_offset, window=window),
                paged_prefill_attention_plain(q, k, v, table, slot,
                                              q_offset, window=window),
                kd, p_round)
            if kd == torch.float32:
                errs["paged_prefill_attention"] = max(
                    errs["paged_prefill_attention"], err)
    torch.cuda.synchronize()

    # times at the paged engine's shapes: f32 pool, no window
    src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    rows = []
    q, k, v, table, pos = _paged_inputs(1, torch.float32, torch.float32)
    for ns in (1, 2):
        work, grid = _working_ctas(pos, ns)
        _log(f"[kernels] paged decode at pos {POS}, {ns} split(s): {work} "
             f"working CTAs of a {grid}-CTA grid")
    bound = _bound_ms(q, k, pos, paged=True)
    lib_ms = _time_ms(_paged_library_call(q, k, v, table, pos))
    for name, run, plain, line in (
            ("paged_decode_attention",
             lambda: paged_decode_attention_cuda(q, k, v, table, pos),
             lambda: paged_decode_attention_plain(q, k, v, table, pos),
             131),
            ("paged_decode_attention_splitk",
             lambda: paged_decode_attention_splitk_cuda(
                 q, k, v, table, pos, num_splits=2),
             lambda: paged_decode_attention_plain(q, k, v, table, pos,
                                                  num_splits=2),
             325)):
        rows.append(_timed_row(name, run, plain, lib_ms, bound, src,
                               f"src/repro/kernels/paged_attention.py:"
                               f"{line}", errs[name]))
    q_offset = S // 2 - CHUNK
    q, k, v, table, _ = _paged_inputs(1, torch.float32, torch.float32,
                                      chunk=CHUNK)
    bound = _prefill_bound_ms(q, k, q_offset)
    lib_ms = _time_ms(_prefill_library_call(q, k, v, table[slot], q_offset))
    rows.append(_timed_row(
        "paged_prefill_attention",
        lambda: paged_prefill_attention_cuda(q, k, v, table[slot], q_offset),
        lambda: paged_prefill_attention_plain(q, k, v, table, slot,
                                              q_offset),
        lib_ms, bound, src, "src/repro/kernels/paged_attention.py:228",
        errs["paged_prefill_attention"]))
    return rows


QUANT = ("int8", "fp8")  # the quantized pools' kv_dtype names


def _quant_paged_inputs(t, name, chunk=0, positions=POS):
    """``_paged_inputs``' f32 pools quantized per token and KV head as the
    engine writes them: (q, k, v, k_scale, v_scale, table, pos)."""
    from repro_torch.models.attention import KV_QUANT_DTYPES, quantize_kv

    q, k, v, table, pos = _paged_inputs(t, torch.float32, torch.float32,
                                        chunk=chunk, positions=positions)
    (kq, ks), (vq, vs) = (quantize_kv(x, KV_QUANT_DTYPES[name])
                          for x in (k, v))
    return q, kq, vq, ks, vs, table, pos


def _check_quant_bitwise(name):
    """On a 1-byte pool: slot 3 alone equals it in the batch, bitwise
    (T = 1 and 4, split-K 2), and split-K at 2, 4 and 8 splits (4096,
    2048 and 1024 keys: whole 1-byte chunks) equals the single pass,
    bitwise."""
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda)

    def quant(t, positions):
        q, k, v, ks, vs, table, pos = _quant_paged_inputs(
            t, name, positions=positions)
        return ((q, k, v, table, pos, ks, vs),
                (q[3:], k, v, table[3:], pos[3:], ks, vs))

    def decode(q, k, v, table, pos, ks, vs):
        return paged_decode_attention_cuda(q, k, v, table, pos, k_scale=ks,
                                           v_scale=vs)

    def splitk(q, k, v, table, pos, ks, vs, num_splits):
        return paged_decode_attention_splitk_cuda(
            q, k, v, table, pos, num_splits=num_splits, k_scale=ks,
            v_scale=vs)

    _check_slot_alone(f"paged_decode_attention_{name}", quant, decode,
                      splitk)
    for positions in (POS, POS_EDGES):
        args, _ = quant(1, positions)
        one = decode(*args)
        for ns in (2, 4, 8):
            same = torch.equal(splitk(*args, ns), one)
            _log(f"[kernels] paged_decode_attention_splitk_{name} "
                 f"pos={positions} ns={ns}: bitwise the single pass: "
                 f"{same}")
            if not same:
                raise AssertionError(f"split-K at whole chunks on {name} "
                                     f"differs from the single pass")


def phase_quant_kernels():
    """The three paged kernels on int8 and fp8 pools (their scale branch)
    against their plain versions at phase 3's shapes, then timed at the
    paged engine's: T = 1 decode and split-K 2 at POS, and the 256-row
    prefill chunk at offset 3840.  The library call is SDPA on the pools
    dequantized and gathered outside the timed call."""
    from repro_torch.kernels.ops import (paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)
    from repro_torch.models.attention import dequantize_kv

    src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    slot = B - 1
    rows = []
    for name in QUANT:
        errs = {"paged_decode_attention": 0.0,
                "paged_decode_attention_splitk": 0.0,
                "paged_prefill_attention": 0.0}
        for positions in (POS, POS_EDGES):
            for t, ns, window in ((1, 1, 0), (1, 1, 1024), (4, 1, 0),
                                  (4, 1, 1024), (1, 2, 0), (1, 2, 1024)):
                q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                    t, name, positions=positions)
                sc = dict(k_scale=ks, v_scale=vs, window=window)
                if ns == 1:
                    kname = "paged_decode_attention"
                    got = paged_decode_attention_cuda(q, k, v, table, pos,
                                                      **sc)
                else:
                    kname = "paged_decode_attention_splitk"
                    got = paged_decode_attention_splitk_cuda(
                        q, k, v, table, pos, num_splits=ns, **sc)
                want = paged_decode_attention_plain(q, k, v, table, pos,
                                                    num_splits=ns, **sc)
                errs[kname] = max(errs[kname], _check(
                    f"{kname} pos={positions} T={t} ns={ns} "
                    f"window={window} pool={name}", got, want, k.dtype))
        for c, q_offset, window in ((CHUNK, S // 2 - CHUNK, 0),
                                    (CHUNK, S // 2 - CHUNK, 1024),
                                    (RAGGED, S // 2, 0),
                                    (RAGGED, S // 2, 200)):
            q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name,
                                                            chunk=c)
            sc = dict(k_scale=ks, v_scale=vs, window=window)
            errs["paged_prefill_attention"] = max(
                errs["paged_prefill_attention"], _check(
                    f"paged_prefill_attention C={c} q_offset={q_offset} "
                    f"window={window} pool={name}",
                    paged_prefill_attention_cuda(q, k, v, table[slot],
                                                 q_offset, **sc),
                    paged_prefill_attention_plain(q, k, v, table, slot,
                                                  q_offset, **sc), k.dtype))
        _check_quant_bitwise(name)
        torch.cuda.synchronize()

        q, k, v, ks, vs, table, pos = _quant_paged_inputs(1, name)
        sc = dict(k_scale=ks, v_scale=vs)
        bound = _bound_ms(q, k, pos, paged=True)
        lib_ms = _time_ms(_paged_library_call(
            q, dequantize_kv(k, ks), dequantize_kv(v, vs), table, pos))
        for kname, run, plain, line in (
                ("paged_decode_attention",
                 lambda: paged_decode_attention_cuda(q, k, v, table, pos,
                                                     **sc),
                 lambda: paged_decode_attention_plain(q, k, v, table, pos,
                                                      **sc), 131),
                ("paged_decode_attention_splitk",
                 lambda: paged_decode_attention_splitk_cuda(
                     q, k, v, table, pos, num_splits=2, **sc),
                 lambda: paged_decode_attention_plain(
                     q, k, v, table, pos, num_splits=2, **sc), 325)):
            rows.append(_timed_row(
                f"{kname}_{name}", run, plain, lib_ms, bound, src,
                f"src/repro/kernels/paged_attention.py:{line}", errs[kname]))
        q_offset = S // 2 - CHUNK
        q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name, chunk=CHUNK)
        sc = dict(k_scale=ks, v_scale=vs)
        bound = _prefill_bound_ms(q, k, q_offset)
        lib_ms = _time_ms(_prefill_library_call(
            q, dequantize_kv(k, ks), dequantize_kv(v, vs), table[slot],
            q_offset))
        rows.append(_timed_row(
            f"paged_prefill_attention_{name}",
            lambda: paged_prefill_attention_cuda(q, k, v, table[slot],
                                                 q_offset, **sc),
            lambda: paged_prefill_attention_plain(q, k, v, table, slot,
                                                  q_offset, **sc),
            lib_ms, bound, src, "src/repro/kernels/paged_attention.py:228",
            errs["paged_prefill_attention"]))
        for row in rows[-3:]:
            row["dtype"] = name
    return rows


def _timed_row(name, run, plain, lib_ms, bound, source, replaces, err):
    """Times of the kernel and its plain version; ``bound`` is
    ``_bound``'s (ms, what bounds it, the flop rate used)."""
    bound, bound_by, rate = bound
    ms = _time_ms(run)
    plain_ms = _time_ms(plain)
    lib = ("none (no single PyTorch call)" if lib_ms is None
           else f"{lib_ms:.4f} ms")
    _log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
         f"library {lib}, bound {bound:.4f} ms by {bound_by}; flops at "
         f"{rate})")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms}


@contextlib.contextmanager
def _plain_attention():
    """Route the model's kernels (dense decode, paged decode, paged
    prefill, flash attention, SSD chunk) through the plain versions for
    CUDA tensors (for the logits comparisons only)."""
    from repro_torch.kernels import ops

    names = ("decode_attention", "paged_decode_attention",
             "paged_prefill_attention", "flash_attention", "ssd_chunk")
    kernel_paths = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ops, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in kernel_paths.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def _first_call_args(name):
    """Record the arguments of the first call the model makes to
    ``ops.<name>`` (the call itself goes through unchanged)."""
    from repro_torch.kernels import ops

    fn, seen = getattr(ops, name), []

    def record(*args, **kwargs):
        if not seen:
            seen.append(args)
        return fn(*args, **kwargs)

    setattr(ops, name, record)
    try:
        yield seen
    finally:
        setattr(ops, name, fn)


def _profile_tick(run, label, ticks=3, top=8):
    """Device time of ``run`` by kernel under ``torch.profiler``: the
    kernels that took the most, and the share of the window the card was
    busy."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    # the raw events: ``prof.events()`` would first build the host ops'
    # tree in Python, seconds a call, for kernel times that are the same
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or _filter_name(e.name())
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        name = _rewrite_name(e.name(), with_wildcard=True)
        us, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (us + (e.end_ns() - e.start_ns()) / 1e3, n + 1)
    if not by_kernel:
        _log(f"[profile] {label}: not measured (the profiler saw no "
             f"device kernels)")
        return
    busy = sum(us for us, _ in by_kernel.values())
    _log(f"[profile] {label}: {wall / ticks * 1e3:.3f} ms per tick under "
         f"the profiler, device kernels {busy / ticks / 1e3:.3f} ms per "
         f"tick, busy {busy / (wall * 1e6):.3f} of the window")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:top]:
        _log(f"[profile]   {us / ticks / 1e3:8.3f} ms/tick {n / ticks:6.1f} "
             f"launches/tick  {name[:90]}")


def _all_kernels():
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    return (decode_attention_cuda, decode_attention_splitk_cuda,
            paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
            paged_prefill_attention_cuda)


def _time_ticks(ticks, label):
    """One decode tick per fan-out in ``ticks`` ({splits: run}), timed over
    alternated rounds (1, 2, 2, 1, 1, 2; median of 10 each), then each
    under the profiler."""
    readings = {s: [] for s in ticks}
    for splits in (1, 2, 2, 1, 1, 2):
        readings[splits].append(_time_ms(ticks[splits], iters=10, warmup=2,
                                         queued=False))
    for splits, ms in readings.items():
        _log(f"[engine] {label}, splits={splits}: "
             f"{', '.join(f'{x:.3f}' for x in ms)} ms (median of 10 each)")
    for splits, run in ticks.items():
        _profile_tick(run, f"{label} splits={splits}")


def make_model(arch="internlm2-1.8b", num_layers=None):
    """``arch`` at its full width, seeded random f32 weights, f32 cache;
    ``num_layers`` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _log(f"[engine] {cfg.name}: {cfg.num_layers} layers d_model "
         f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} vocab "
         f"{cfg.vocab_size}; init {time.perf_counter() - t0:.1f}s")
    return model, params


def phase_engine(model, params, label="dense"):
    """Phase 4 on ``model``: dense continuous serving with a 4200-token
    prompt (split-K engages), decode logits against the plain path, a
    timed and profiled tick, and a wave trace.  Returns the dense
    kernels' launches in the continuous run."""
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from repro_torch.runtime.steps import compiled_step

    kernels = _all_kernels()
    cfg = model.cfg

    rng = np.random.default_rng(0)
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=S,
                                                 prefill_chunk=256))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(((4200, 16), (17, 24), (64, 24),
                                    (200, 24), (33, 8)))]
    handles = [eng.submit(r) for r in reqs]
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    toks = sum(len(r.output) for r in done)
    ttft = sorted(h.metrics()["ttft_s"] for h in handles)
    _log(f"[engine] {label} continuous: {len(done)}/{len(reqs)} requests, "
         f"{toks} tokens in {wall:.3f}s = {toks / wall:.2f} tok/s; ttft p50 "
         f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
         f"ms; launches {launches}")
    if len(done) != len(reqs) or not all(
            len(r.output) == r.max_new_tokens for r in done):
        raise AssertionError("continuous run did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        raise AssertionError("token outside the vocabulary")
    if min(launches["decode_attention_cuda"],
           launches["decode_attention_splitk_cuda"]) <= 0 \
            or any(n.startswith("paged") and c for n, c in launches.items()):
        raise AssertionError(f"dense run: a dense kernel was not launched, "
                             f"or a paged one was: {launches}")

    # one decode step, kernels against the plain path, on the run's cache
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    logits = {}
    for splits in (1, 2):
        step = compiled_step(model, "decode_one", decode_splits=splits)
        got, _ = step(params, eng.caches, toks_in, pos)
        logits[splits] = got
        with _plain_attention():
            want, _ = step(params, eng.caches, toks_in, pos)
        err = float((got - want).abs().max())
        _log(f"[engine] {label} decode logits, kernels vs plain "
             f"(splits={splits}): "
             f"max_abs_err {err:.3g} (tol {LOGIT_TOL}); |logits| max "
             f"{float(want.abs().max()):.3g}")
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL
                and got.shape == (4, cfg.vocab_size)):
            raise AssertionError("decode logits disagree")
    # S / 2 = 4096 is whole chunks, so split-K is the single pass
    same = torch.equal(logits[1], logits[2])
    _log(f"[engine] {label} decode logits, splits=2 equal splits=1 "
         f"bitwise: {same}")
    if not same:
        raise AssertionError("split-K decode logits differ from the single "
                             "pass")
    # one whole decode tick (24 layers + unembedding + argmax) at these
    # positions, single pass against split-K 2, alternated over rounds;
    # then each under the profiler
    _time_ticks({s: functools.partial(
        compiled_step(model, "serve", decode_splits=s), params, eng.caches,
        toks_in, pos) for s in (1, 2)},
        f"{label} decode tick at pos {pos.tolist()}")
    del eng

    # wave mode: the lockstep baseline runs the single-pass kernel
    wave = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=256,
                                                  mode="wave"))
    for i in range(6):
        wave.submit(Request(100 + i, rng.integers(
            0, cfg.vocab_size, size=5 + i).astype(np.int32),
            max_new_tokens=6))
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    wdone = wave.run()
    torch.cuda.synchronize()
    wwall = time.perf_counter() - t0
    wl = {k.__name__: k.launches for k in kernels}
    wtoks = sum(len(r.output) for r in wdone)
    _log(f"[engine] {label} wave: {len(wdone)}/6 requests, {wtoks} tokens in "
         f"{wwall:.3f}s; launches {wl}")
    if len(wdone) != 6 or wl["decode_attention_cuda"] <= 0:
        raise AssertionError("wave run failed or launched no kernel")
    return {"decode_attention": launches["decode_attention_cuda"],
            "decode_attention_splitk":
                launches["decode_attention_splitk_cuda"]}


def _paged_trace(model, params, label, kv_dtype=""):
    """Serve prompt A (4200 tokens) and three short prompts, then
    B = A[:4096] + 50 fresh tokens once A's pages are registered, through
    ``cache="paged"`` (16-token pages, prefix cache on, ``kv_dtype``).
    Every request must finish with tokens in the vocabulary, B must hit
    the prefix cache, the three paged kernels and no dense one must launch,
    and B served alone with the prefix cache off must give B's tokens.
    Returns (the engine, B's prompt, the paged kernels' launches, the
    pool's bytes per page)."""
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    kernels = _all_kernels()
    cfg = model.cfg
    rng = np.random.default_rng(1)
    config = ServeConfig(batch_slots=4, max_len=S, prefill_chunk=CHUNK,
                         cache="paged", page_size=PAGE, kv_dtype=kv_dtype)
    eng = ServeEngine(model, params, config)
    prompt_a = rng.integers(0, cfg.vocab_size, size=4200).astype(np.int32)
    # the 1-token request finishes at its prefill, so B finds a free slot
    reqs = [Request(0, prompt_a, max_new_tokens=16)] + [
        Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=m)
        for i, (n, m) in ((1, (17, 24)), (2, (64, 1)), (3, (200, 24)))]
    prompt_b = np.concatenate([prompt_a[:4096], rng.integers(
        0, cfg.vocab_size, size=50).astype(np.int32)])
    req_b = Request(4, prompt_b, max_new_tokens=16)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.step()  # prefills A (and registers its pages) and the short ones
    handles.append(eng.submit(req_b))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    stats = eng.kv.stats()
    toks = sum(len(r.output) for r in done)
    ttft = sorted(h.metrics()["ttft_s"] for h in handles)
    ttft_b = handles[-1].metrics()["ttft_s"]
    page_bytes = eng.kv_reserved_bytes() / eng.kv.pool.num_pages
    _log(f"[engine] {label} continuous: {len(done)}/5 requests, {toks} "
         f"tokens in {wall:.3f}s = {toks / wall:.2f} tok/s; ttft p50 "
         f"{statistics.median(ttft) * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} "
         f"ms; B (prefix hit) ttft {ttft_b * 1e3:.1f} ms; kv {stats}; pool "
         f"{eng.kv_reserved_bytes()} bytes, {page_bytes:.0f} per page, "
         f"{2 ** 30 / page_bytes:.1f} pages per GiB; launches {launches}")
    finished = [h.req for h in handles]
    if not all(r.done and len(r.output) == r.max_new_tokens
               for r in finished):
        raise AssertionError(f"{label} run did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in finished for t in r.output):
        raise AssertionError("token outside the vocabulary")
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"B did not hit the prefix cache: {stats}")
    paged = {n: c for n, c in launches.items() if n.startswith("paged")}
    if min(paged.values()) <= 0 or any(
            c for n, c in launches.items() if not n.startswith("paged")):
        raise AssertionError(f"{label} run: a paged kernel was not "
                             f"launched, or a dense one was: {launches}")

    # B alone, prefix cache off: the prefix-hit prefill read the same K/V
    # from A's pages that B's own prefill writes
    solo = ServeEngine(model, params, ServeConfig(
        batch_slots=4, max_len=S, prefill_chunk=CHUNK, cache="paged",
        page_size=PAGE, prefix_cache=False, kv_dtype=kv_dtype))
    h_solo = solo.submit(Request(5, prompt_b.copy(), max_new_tokens=16))
    solo.run()
    ttft_solo = h_solo.metrics()["ttft_s"]
    _log(f"[engine] {label}: B alone, prefix cache off: ttft "
         f"{ttft_solo * 1e3:.1f} ms (with the hit {ttft_b * 1e3:.1f} ms); "
         f"tokens equal: {h_solo.req.output == req_b.output}")
    if h_solo.req.output != req_b.output:
        raise AssertionError("B's tokens differ with the prefix cache off")
    del solo
    return eng, prompt_b, paged, page_bytes


def _check_chunk_by_call(label, what, run, caches, num_layers):
    """The prefill chunk ``run`` through the kernels, then each layer's
    paged prefill call held against its plain version on the same
    arguments (the pools and scales as the chunk's own writes left them,
    the layer's window), at the kernels' tolerance; the logits against the
    plain route are printed, with the count of pool values the two routes
    quantized differently (each route writes the K/V its own layers
    computed, and a value near a rounding boundary rounds either way)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_leaves

    fn, calls = ops.paged_prefill_attention, []

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    ops.paged_prefill_attention = record
    try:
        got = run()[0]
    finally:
        ops.paged_prefill_attention = fn
    if len(calls) != num_layers or not torch.isfinite(got).all():
        raise AssertionError(f"{label} {what}: {len(calls)} paged prefill "
                             f"calls for {num_layers} layers, or logits not "
                             f"finite")
    worst = 0.0
    for i, (args, kwargs, out) in enumerate(calls):
        worst = max(worst, _check(
            f"{label} {what}, layer {i} window={kwargs['window']}", out,
            ops.paged_prefill_attention_plain(*args, **kwargs),
            args[1].dtype))
    del calls
    pools = [t.clone() for t in tree_leaves(caches)]
    with _plain_attention():
        want = run()[0]
    flips = sum(int((a != b).sum()) for a, b in zip(pools,
                                                    tree_leaves(caches))
                if a.element_size() == 1)
    _log(f"[engine] {label} {what}: {num_layers} paged prefill calls each "
         f"within tol of their plain versions (worst {worst:.3g}); logits "
         f"against the plain route {float((got - want).abs().max()):.3g} "
         f"(not held: the routes quantized {flips} pool values "
         f"differently)")
    del pools


def _paged_logits_and_tick(eng, params, prompt_b, label,
                           chunk_by_call=False):
    """One paged decode step (single pass and split-K 2) and one prefill
    chunk at 3840, kernels against the plain path, on the engine's pools
    through a permuted table of all pages; then a decode tick timed and
    profiled, single pass against split-K 2.  ``chunk_by_call``: the
    chunk is held layer by layer (``_check_chunk_by_call``), not by its
    logits."""
    from repro_torch.runtime.steps import compiled_step

    model, cfg = eng.model, eng.model.cfg
    g = torch.Generator(device="cuda").manual_seed(2)
    table = (torch.randperm(N_PAGES - 1, generator=g, device="cuda") + 1)[
        :B * MAX_PAGES].reshape(B, MAX_PAGES).to(torch.int32).contiguous()
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    chunk = torch.as_tensor(prompt_b[None, :CHUNK].astype(np.int64),
                            device="cuda")
    split2 = type(model)(model.cfg, model.knobs.with_(decode_splits=2),
                         model.device)
    checks = [(f"decode (splits={m.knobs.decode_splits or 1})",
               functools.partial(m.decode_step_paged, params, eng.caches,
                                 toks_in, pos, table, page_size=PAGE))
              for m in (model, split2)]
    checks.append((f"prefill chunk at {S // 2 - CHUNK}", functools.partial(
        model.prefill_chunk_step_paged, params, eng.caches, chunk, 1,
        S // 2 - CHUNK, table, page_size=PAGE)))
    for what, run in checks:
        if chunk_by_call and what.startswith("prefill"):
            _check_chunk_by_call(label, what, run, eng.caches,
                                 cfg.num_layers)
            continue
        got = run()[0]
        with _plain_attention():
            want = run()[0]
        err = float((got - want).abs().max())
        _log(f"[engine] {label} {what} logits, kernels vs plain: "
             f"max_abs_err {err:.3g} (tol {LOGIT_TOL}); |logits| max "
             f"{float(want.abs().max()):.3g}")
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL
                and got.shape[-1] == cfg.vocab_size):
            raise AssertionError(f"{label} {what} logits disagree")
    _time_ticks({s: functools.partial(
        compiled_step(model, "paged_serve", page_size=PAGE,
                      decode_splits=s), params, eng.caches, toks_in, pos,
        table) for s in (1, 2)},
        f"{label} decode tick at pos {pos.tolist()}")


def phase_paged_engine(model, params, label="paged"):
    """The same model through ``cache="paged"`` (f32 pools): phase 4b's
    trace, then its logits checks and tick.  Returns the paged kernels'
    launches and the pool's bytes per page."""
    eng, prompt_b, paged, page_bytes = _paged_trace(model, params, label)
    _paged_logits_and_tick(eng, params, prompt_b, label)
    del eng
    return {n.removesuffix("_cuda"): c for n, c in paged.items()}, page_bytes


def _pools(caches):
    """The first layer stack's pools of a plan's cache tree."""
    while "k" not in caches:
        caches = next(iter(caches.values()))
    return caches


def phase_quant_engine(model, params, f32_page_bytes, names=QUANT,
                       label="paged", chunk_by_call=False):
    """Phase 4b's trace on int8 and then fp8 pools (``kv_dtype``): the same
    checks, pools of the quantized dtype with f32 scale leaves, logits
    through the kernels against the plain versions on the same quantized
    pools, and the pool's pages per GiB against the f32 pool's.  Returns
    the paged kernels' launches per dtype, keyed as phase 3q's rows."""
    from repro_torch.models.attention import KV_QUANT_DTYPES

    launches = {}
    for name in names:
        eng, prompt_b, paged, page_bytes = _paged_trace(
            model, params, f"{label} {name}", kv_dtype=name)
        pools = _pools(eng.caches)
        dtypes = {k: v.dtype for k, v in pools.items()}
        _log(f"[engine] {label} {name}: pool leaves {dtypes}; pages per GiB "
             f"{2 ** 30 / page_bytes:.1f} against the f32 pool's "
             f"{2 ** 30 / f32_page_bytes:.1f} "
             f"({f32_page_bytes / page_bytes:.3f}x)")
        want = {"k": KV_QUANT_DTYPES[name], "v": KV_QUANT_DTYPES[name],
                "k_scale": torch.float32, "v_scale": torch.float32}
        if dtypes != want:
            raise AssertionError(f"{name} pools hold {dtypes}, not {want}")
        _paged_logits_and_tick(eng, params, prompt_b, f"{label} {name}",
                               chunk_by_call)
        del eng, pools
        launches.update({f"{n.removesuffix('_cuda')}_{name}": c
                         for n, c in paged.items()})
    return launches


# ------------------------------------------------ 4d: the verify block
DRAFT_K = 3
VERIFY_T = DRAFT_K + 1  # query rows per slot of a verify block; G * T = 8
# every row of the block inside the cache; 253, 1021 and 4093 put the
# block across the chunk boundaries at 256, 1024 and 4096
POS_V = [-1, 1000, 4200, S - VERIFY_T]
POS_V_EDGES = [253, 1021, 4093, S - VERIFY_T]


def _rows_alone(label, run, q, pos):
    """Row t of ``run(q, pos)`` on the T-row block equals, bitwise, ``run``
    on row t alone at pos + t (under the block's ``active``)."""
    block = run(q, pos, None)
    active = (pos >= 0).to(torch.int32)
    differ = [t for t in range(q.shape[1]) if not torch.equal(
        block[:, t:t + 1], run(q[:, t:t + 1].contiguous(), pos + t, active))]
    _log(f"[verify] {label}: rows of the T={q.shape[1]} block equal the "
         f"T=1 launches at pos + t bitwise: {not differ}")
    if differ:
        raise AssertionError(f"{label}: rows {differ} of the block differ "
                             f"from the one-token launches")


def phase_verify_kernels():
    """#1, #3 and #3q (int8) at T = 4: each row bitwise the T = 1 launch at
    pos + t, at both position sets and windows 0 and 1024; then #1 and #3
    timed at T = 4 (the errors against the plain versions at T = 4 are
    phases 3's and 3q's)."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         paged_decode_attention_plain)
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda

    f32 = torch.float32
    for positions in (POS_V, POS_V_EDGES):
        for window in (0, 1024):
            q, k, v, pos = _inputs(VERIFY_T, f32, f32, positions=positions)
            _rows_alone(f"decode_attention pos={positions} window={window}",
                        lambda qq, p, a: decode_attention_cuda(
                            qq, k, v, p, active=a, window=window), q, pos)
            q, k, v, table, pos = _paged_inputs(VERIFY_T, f32, f32,
                                                positions=positions)
            _rows_alone(f"paged_decode_attention pos={positions} "
                        f"window={window}",
                        lambda qq, p, a: paged_decode_attention_cuda(
                            qq, k, v, table, p, active=a, window=window),
                        q, pos)
            q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                VERIFY_T, "int8", positions=positions)
            _rows_alone(f"paged_decode_attention int8 pos={positions} "
                        f"window={window}",
                        lambda qq, p, a: paged_decode_attention_cuda(
                            qq, k, v, table, p, active=a, window=window,
                            k_scale=ks, v_scale=vs), q, pos)
    torch.cuda.synchronize()
    rows = []
    q, k, v, pos = _inputs(VERIFY_T, f32, f32, positions=POS_V)
    err = _check(f"decode_attention T={VERIFY_T} pos={POS_V}",
                 decode_attention_cuda(q, k, v, pos),
                 decode_attention_plain(q, k, v, pos), f32)
    rows.append(_timed_row(
        "decode_attention_verify", lambda: decode_attention_cuda(q, k, v, pos),
        lambda: decode_attention_plain(q, k, v, pos),
        _time_ms(_library_call(q, k, v, pos)), _bound_ms(q, k, pos),
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:131", err))
    q, k, v, table, pos = _paged_inputs(VERIFY_T, f32, f32, positions=POS_V)
    err = _check(f"paged_decode_attention T={VERIFY_T} pos={POS_V}",
                 paged_decode_attention_cuda(q, k, v, table, pos),
                 paged_decode_attention_plain(q, k, v, table, pos), f32)
    rows.append(_timed_row(
        "paged_decode_attention_verify",
        lambda: paged_decode_attention_cuda(q, k, v, table, pos),
        lambda: paged_decode_attention_plain(q, k, v, table, pos),
        _time_ms(_paged_library_call(q, k, v, table, pos)),
        _bound_ms(q, k, pos, paged=True),
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:131", err))
    for row in rows:
        row["rows_per_slot"] = VERIFY_T
    return rows


def _repeating_prompts(vocab, rng):
    """Three ~1000-token prompts, each a 64-token pattern repeated (the
    n-gram drafter finds continuations in them), and a 4200-token random
    one (the split-K autotuner's prompt of phase 4), with their token
    budgets."""
    out = []
    for n in (1000, 1010, 1020):
        pattern = rng.integers(0, vocab, size=64).astype(np.int32)
        out.append((np.tile(pattern, -(-n // 64))[:n], 48))
    out.append((rng.integers(0, vocab, size=4200).astype(np.int32), 16))
    return out


def _run_engine(model, params, config, requests):
    """Serve ``requests`` [(prompt, max_new, sampling or None, priority,
    tenant)] on a fresh engine; returns (engine, {req_id: tokens}, wall
    seconds, tokens)."""
    from repro_torch.runtime.serve import (Request, SamplingParams,
                                           ServeEngine)

    eng = ServeEngine(model, params, config)
    for i, (prompt, max_new, sp, prio, tenant) in enumerate(requests):
        eng.submit(Request(i, prompt.copy(), max_new_tokens=max_new,
                           sampling=sp or SamplingParams(), priority=prio,
                           tenant=tenant))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = {r.req_id: list(r.output) for r in done}
    if len(streams) != len(requests) or any(
            not 0 <= t < model.cfg.vocab_size for o in streams.values()
            for t in o):
        raise AssertionError("a request did not finish, or a token is "
                             "outside the vocabulary")
    return eng, streams, wall, sum(len(o) for o in streams.values())


def _verify_logits(eng, params, label, t=VERIFY_T):
    """The verify block's logits (``t`` rows a slot) against ``t``
    sequential one-token steps, bitwise, on the engine's caches, at pos
    [253, 1000, -1, 4200] (slot 0's block straddles the chunk boundary at
    256)."""
    model = eng.model
    pos = np.array([253, 1000, -1, 4200], np.int32)
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, model.cfg.vocab_size, (B, t),
                         generator=g, device="cuda")
    extra = {}
    if eng.kv is not None:
        table = (torch.randperm(eng.kv.pool.num_pages - 1, generator=g,
                                device="cuda") + 1)[:B * MAX_PAGES]
        extra = dict(page_idx=table.reshape(B, MAX_PAGES).to(
            torch.int32).contiguous(), page_size=PAGE)
        dec, spec = model.decode_step_paged, model.decode_step_spec_paged
    else:
        dec, spec = model.decode_step, model.decode_step_spec
    seq = torch.stack([dec(params, eng.caches, toks[:, i:i + 1], pos + i,
                           **extra)[0] for i in range(t)], dim=1)
    got = spec(params, eng.caches, toks, pos, **extra)[0]
    live = torch.as_tensor(pos >= 0, device="cuda")
    same = torch.equal(got[live], seq[live])
    _log(f"[verify] {label}: decode_step_spec logits (T={t}) equal "
         f"{t} sequential decode steps bitwise: {same}; finite "
         f"{bool(torch.isfinite(got).all())}")
    if not same or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: verify logits differ from "
                             f"sequential decode")


def _replay_drafter(prompts, streams, vocab):
    """A drafter for models whose random weights never repeat their
    context (the n-gram drafter then proposes nothing): for a slot whose
    history is one of ``prompts`` followed by the first n tokens of its
    plain greedy stream, it proposes the next k - 1 tokens of that stream
    and one that is not, so every verify tick accepts drafts and rejects
    one; once a history leaves the plain stream it proposes nothing.  A
    pure function of the history, as the engine requires."""
    from repro_torch.runtime.draft import Drafter

    table = [(np.asarray(p, np.int32), list(s))
             for p, s in zip(prompts, streams)]

    class Replay(Drafter):
        name = "replay"

        def propose(self, context, k):
            ctx = np.asarray(context, np.int32)
            for prompt, stream in table:
                n = len(ctx) - len(prompt)
                if n >= 1 and np.array_equal(ctx[:len(prompt)], prompt) \
                        and ctx[len(prompt):].tolist() == stream[:n]:
                    nxt = stream[n:n + k]
                    if len(nxt) == k:
                        nxt[-1] = (nxt[-1] + 1) % vocab
                    return np.asarray(nxt, np.int32)
            return np.zeros(0, np.int32)

    return Replay()


def _spec_pair(model, params, label, cache_kw, replay=False,
               draft_k=DRAFT_K):
    """The greedy trace on the plain engine and on the speculative one
    (``draft_k``, 3 by default; the n-gram drafter, or with ``replay`` the
    ``_replay_drafter`` of the plain streams): equal streams, verify
    launches of the layout's decode kernel only, each at T = draft_k + 1
    once per layer per verify tick; then the verify logits check, and a
    plain tick against a verify tick, timed and profiled.  Returns the
    verify launches."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.runtime.serve import ServeConfig

    rng = np.random.default_rng(5)
    reqs = [(p, m, None, 0, "default")
            for p, m in _repeating_prompts(model.cfg.vocab_size, rng)]
    base = dict(batch_slots=B, max_len=S, prefill_chunk=CHUNK, **cache_kw)
    eng, plain, wall_p, toks_p = _run_engine(model, params,
                                             ServeConfig(**base), reqs)
    del eng
    spec_kw = dict(draft_k=draft_k)
    if replay:
        spec_kw["drafter"] = _replay_drafter(
            [r[0] for r in reqs], [plain[i] for i in range(len(reqs))],
            model.cfg.vocab_size)
    kernels = (decode_attention_cuda, paged_decode_attention_cuda)
    for kern in kernels:
        kern.verify_launches = 0
    eng, spec, wall_s, toks_s = _run_engine(
        model, params, ServeConfig(**spec_kw, **base), reqs)
    verify = {k.__name__: k.verify_launches for k in kernels}
    st = eng.spec_stats()
    _log(f"[verify] {label}: plain engine {toks_p} tokens in {wall_p:.3f}s "
         f"= {toks_p / wall_p:.2f} tok/s; speculative (draft_k={draft_k}) "
         f"{toks_s} tokens in {wall_s:.3f}s = {toks_s / wall_s:.2f} tok/s; "
         f"acceptance {st['acceptance_rate']:.3f} ({st['accepted']}/"
         f"{st['proposed']}), {st['tokens_per_tick']:.3f} tokens per verify "
         f"tick over {st['spec_ticks']} verify ticks; verify launches "
         f"{verify}; streams equal: {spec == plain}")
    if spec != plain:
        raise AssertionError(f"{label}: speculative streams differ from the "
                             f"plain engine's")
    want = "paged_decode_attention_cuda" if eng.kv is not None \
        else "decode_attention_cuda"
    if st["spec_ticks"] < 1 or verify[want] != \
            st["spec_ticks"] * model.cfg.num_layers or any(
                n != want and c for n, c in verify.items()):
        raise AssertionError(f"{label}: the verify ticks did not run the "
                             f"{want} kernel at T={draft_k + 1}: {verify}")
    _verify_logits(eng, params, label, draft_k + 1)
    # a plain tick and a verify tick at pos [4300, 300, -1, 4200]
    pos = np.array([4300, 300, -1, 4200], np.int32)
    feed = np.tile(np.array([[5], [6], [7], [8]], np.int32),
                   (1, draft_k + 1))
    extra = () if eng.kv is None else (eng._page_table(),)
    ticks = {"plain": functools.partial(eng._step, params, eng.caches,
                                        feed[:, :1], pos, *extra),
             "verify": functools.partial(eng._spec_step, params, eng.caches,
                                         feed, pos, *extra)}
    for name, run in ticks.items():
        ms = [_time_ms(run, iters=10, warmup=2, queued=False)
              for _ in range(2)]
        _log(f"[verify] {label} {name} tick at pos {pos.tolist()}: "
             f"{', '.join(f'{x:.3f}' for x in ms)} ms (median of 10 each)")
        _profile_tick(run, f"{label} {name} tick")
    del eng
    _free_device()
    return verify[want]


def _sampled_checks(model, params):
    """Seeded sampling at temperature 0.8, top-k 50, top-p 0.9 on the dense
    cache: the same requests in other slots give the same streams, the
    speculative engine equals the plain one, top-k 1 and temperature 0
    equal greedy; and on one logits tensor the card's sampler equals the
    CPU's (bits and uniforms bitwise, tokens equal)."""
    from repro_torch.runtime import sampling
    from repro_torch.runtime.serve import SamplingParams, ServeConfig

    rng = np.random.default_rng(6)
    prompts = [p[:256] for p, _ in _repeating_prompts(model.cfg.vocab_size,
                                                      rng)[:3]]
    sp = [SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=100 + i)
          for i in range(3)]
    cfg = dict(batch_slots=B, max_len=S, prefill_chunk=CHUNK)
    reqs = [(p, 24, s, 0, "default") for p, s in zip(prompts, sp)]
    _, first, wall, toks = _run_engine(model, params, ServeConfig(**cfg),
                                       reqs)
    # other slots: a greedy request first, the sampled ones reversed
    filler = (prompts[0][:17], 40, None, 0, "default")
    _, moved, _, _ = _run_engine(model, params, ServeConfig(**cfg),
                                 [filler] + reqs[::-1])
    moved = {2 - (i - 1): moved[i] for i in range(1, 4)}
    _, spec, _, _ = _run_engine(model, params,
                                ServeConfig(draft_k=DRAFT_K, **cfg), reqs)
    greedy_reqs = [(p, 24, None, 0, "default") for p in prompts]
    _, greedy, _, _ = _run_engine(model, params, ServeConfig(**cfg),
                                  greedy_reqs)
    topk1 = [(p, 24, SamplingParams(temperature=0.8, top_k=1, seed=7), 0,
              "default") for p in prompts]
    _, k1, _, _ = _run_engine(model, params, ServeConfig(**cfg), topk1)
    # temperature 0 beside a sampled request: every tick is a sampled one
    temp0 = [(p, 24, SamplingParams(temperature=0.0, top_k=5, top_p=0.5),
              0, "default") for p in prompts] + [reqs[0]]
    _, t0, _, _ = _run_engine(model, params, ServeConfig(**cfg), temp0)
    t0 = {i: t0[i] for i in range(3)}
    results = {"slots moved": moved == first, "speculative": spec == first,
               "top_k=1 is greedy": k1 == greedy,
               "temperature 0 is greedy": t0 == greedy}
    _log(f"[verify] sampled engine (T=0.8, top-k 50, top-p 0.9): {toks} "
         f"tokens in {wall:.3f}s; {results}")
    if not all(results.values()):
        raise AssertionError(f"sampled engine checks failed: {results}")
    # the card's sampler against the CPU's on one logits tensor
    g = torch.Generator(device="cuda").manual_seed(8)
    logits = torch.randn((B, model.cfg.vocab_size), generator=g,
                         device="cuda") * 3
    keys = np.array([s.key_data(0) for s in sp] + [sp[0].key_data(9)])
    pos = np.array([5, 900, 4200, 0], np.int32)
    args = (pos, np.full(B, 0.8, np.float32), np.full(B, 50, np.int32),
            np.full(B, 0.9, np.float32), keys)
    folded = [sampling.fold_in(sampling.as_key_words(keys, d),
                               torch.as_tensor(pos, device=d))
              for d in ("cuda", "cpu")]
    bits = [sampling.random_bits(f, model.cfg.vocab_size).cpu()
            for f in folded]
    unif = [sampling.uniform(f, model.cfg.vocab_size).cpu() for f in folded]
    tok = [sampling.sample_tokens(x, *args).cpu()
           for x in (logits, logits.cpu())]
    same = {"keys": torch.equal(folded[0].cpu(), folded[1]),
            "bits": torch.equal(*bits),
            "uniforms": torch.equal(unif[0].view(torch.int32),
                                    unif[1].view(torch.int32)),
            "tokens": torch.equal(*tok)}
    _log(f"[verify] sampler on the card against the CPU's, {B} rows of "
         f"{model.cfg.vocab_size}: {same}")
    if not all(same.values()):
        raise AssertionError(f"the card's sampler differs from the CPU's: "
                             f"{same}")


def _preemption_checks(model, params, layouts=("dense", "paged"),
                       lens=((300, 257, 420, 199), (64, 90)), max_len=S):
    """``preempt=True``, ``policy="priority"``: four low-priority requests
    of tenant "batch" (prompt lengths ``lens[0]``) fill the slots, then
    two high-priority ones of tenant "interactive" (``lens[1]``) arrive
    and preempt; every stream equals the run without preemption, dense
    and paged (prefix cache off: no page may stay in use after the
    drain).  Prints the dense checkpoint's bytes and its copy-out and
    copy-in times."""
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    rng = np.random.default_rng(7)
    vocab = model.cfg.vocab_size
    low = [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens[0]]
    high = [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in lens[1]]

    def serve(config):
        eng = ServeEngine(model, params, config)
        for i, p in enumerate(low):
            eng.submit(Request(i, p.copy(), max_new_tokens=24,
                               tenant="batch"))
        eng.step()
        eng.step()
        for i, p in enumerate(high):
            eng.submit(Request(10 + i, p.copy(), max_new_tokens=8,
                               tenant="interactive", priority=5))
        done = eng.run()
        return eng, {r.req_id: (list(r.output), r.preempt_count)
                     for r in done}

    layout_kw = {"dense": {}, "paged": dict(cache="paged", page_size=PAGE,
                                            prefix_cache=False)}
    for label, kw in ((name, layout_kw[name]) for name in layouts):
        cfg = dict(batch_slots=B, max_len=max_len, prefill_chunk=CHUNK,
                   policy="priority", **kw)
        _, want = serve(ServeConfig(**cfg))
        eng, got = serve(ServeConfig(preempt=True, **cfg))
        preempted = [i for i, (_, n) in got.items() if n]
        same = {i: o for i, (o, _) in got.items()} == \
            {i: o for i, (o, _) in want.items()}
        stats = eng.kv.stats() if eng.kv is not None else {}
        _log(f"[verify] preemption {label}: {eng.scheduler.preempted_total} "
             f"preemptions, requests preempted {preempted}; streams equal "
             f"the run without preemption: {same}; kv {stats}")
        if not (same and preempted):
            raise AssertionError(f"preemption {label}: no preemption, or a "
                                 f"resumed stream differs")
        if eng.kv is not None and (stats["in_use_pages"]
                                   or eng.kv.page_table.any()):
            raise AssertionError(f"preemption {label}: pages leaked: "
                                 f"{stats}")
        if eng.kv is None:
            eng._ensure_ckpt_fns()
            outs, ins = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                snap = eng._copy_out(eng.caches, 0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng._copy_in(eng.caches, snap, 0)
                torch.cuda.synchronize()
                outs.append((t1 - t0) * 1e3)
                ins.append((time.perf_counter() - t1) * 1e3)
            nbytes = sum(x.numel() * x.element_size()
                         for x in tree_leaves(snap))
            _log(f"[verify] dense checkpoint of one slot: {nbytes} bytes; "
                 f"copy-out {', '.join(f'{x:.1f}' for x in outs)} ms, "
                 f"copy-in {', '.join(f'{x:.1f}' for x in ins)} ms")
        del eng
        _free_device()


def phase_spec_engine(model, params):
    """Phase 4d on the full-width internlm2: speculative decode (greedy:
    dense, paged f32, paged int8), sampling and preemption.  Returns the
    verify launches, keyed as phase 4d's kernel rows."""
    launches = {
        "decode_attention_verify": _spec_pair(model, params, "dense", {}),
        "paged_decode_attention_verify": _spec_pair(
            model, params, "paged", dict(cache="paged", page_size=PAGE))}
    _spec_pair(model, params, "paged int8",
               dict(cache="paged", page_size=PAGE, kv_dtype="int8"))
    _sampled_checks(model, params)
    _preemption_checks(model, params)
    return launches


# -------------------------------------------------- whole-sequence kernels
FS, FB = 4096, 2  # flash attention: internlm2 prefill of 2 x 4096
SSD = dict(B=2, NC=16, NH=64, G=1, Q=256, HP=64, DS=128)  # mamba2, S=4096
# zamba2-2.7b's mamba2 layers at its 2 x 4096 prefill: 80 heads, ds 64
SSD_ZAMBA2 = dict(B=2, NC=16, NH=80, G=1, Q=256, HP=64, DS=64)
# SSD chunk against its plain version, f32: the kernel multiplies on the
# tensor cores, each f32 product as three TF32 products (3xTF32: the
# dropped small.small term is <= 2^-22 of the product), summed 32 deep by
# the mma's truncating f32 accumulation and then in f32; the plain version
# sums f32 products in another order.  Emulated on the CPU for mamba2's
# chunk (tests/test_torch_ssd_tf32.py) the 3xTF32 route stays within
# 3.7e-7 of max |want| and one TF32 product misses by 3e-4 to 6e-4, so the
# check bites on the split.
SSD_RTOL = 1e-5
# bf16 x, B, C: the kernel rounds att to bf16 before att @ x, as the TPU
# kernel does, where the plain version keeps att in f32, so y moves by up
# to 2^-9 sum_j |att_ij| |x_j| (bounded with |C| |B| for |C.B^T|, doubled);
# and both sides round y to bf16, where a value next to a boundary may
# round either way (one bf16 ulp, 2^-7 |y|).  The state is f32 from the
# same bf16 values on both sides: SSD_RTOL.
SSD_BF16_ATT = 2.0 ** -8


def _flash_inputs(b, s, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, KV, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def _flash_bound_ms(q, k, causal, window):
    """QK + PV flops (4 D per attended (row, key) pair) at the many-row
    kernel's tensor-core rate, against q, K, V and the output read or
    written once (``cost.flash_work``)."""
    from repro_torch.kernels import cost

    b, s, h, d = q.shape
    return cost.flash_work(b, s, h, d, k.shape[2], q.element_size(),
                           k.element_size(), cost.tc_class(q, k),
                           causal=causal, window=window).bound()


def _ssd_inputs(B_, NC, NH, G, Q, HP_, DS, seed=0, dtype=torch.float32):
    """Inputs as ``ssm_forward`` makes them, through the same transposed
    views: x and B/C (B, NC, Q, .) activations in ``dtype``, dt in [1e-3,
    1e-1] (the init's softplus range), a in [-16, -1], cum the inclusive
    cumsum of dt * a within each chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn((B_, NC, Q, NH, HP_), generator=g,
                           device="cuda")).to(dtype)
    bc = (0.5 * torch.randn((B_, NC, Q, G, 2 * DS), generator=g,
                            device="cuda")).to(dtype)
    u = torch.rand((B_, NC, Q, NH), generator=g, device="cuda")
    dt = torch.exp(np.log(1e-3) + (np.log(1e-1) - np.log(1e-3)) * u)
    a = -(1.0 + 15.0 * torch.rand((NH,), generator=g, device="cuda"))
    cum = torch.cumsum(dt * a, dim=2)
    return (x.transpose(2, 3), bc[..., :DS].transpose(2, 3),
            bc[..., DS:].transpose(2, 3), dt.transpose(2, 3),
            cum.transpose(2, 3))


def _ssd_bound_ms(x, b, cuda_cores=False):
    """Products over the lower triangle (the pairs i >= j a chunk needs)
    against x, B, C, dt, cum read once and y, the state written once
    (``cost.ssd_work``): f32 inputs at the 3xTF32 rate; bf16 inputs C.B^T
    and att @ x at the bf16 rate and the state (f32 B * w against bf16 x)
    at the 2xTF32 rate.  ``cuda_cores``: all at the f32 CUDA-core rate
    (the PR 13 design's bound)."""
    from repro_torch.kernels import cost

    bb, nc, nh, q, hp = x.shape
    return cost.ssd_work(bb, nc, nh, q, hp, b.shape[2], b.shape[4],
                         x.element_size(), cuda_cores=cuda_cores).bound()


def _check_ssd(label, got, want, y_extra=None):
    """Max abs error of y and the state, each against SSD_RTOL times its
    plain version's largest magnitude; ``y_extra`` (bf16 inputs) is added
    to y's limit element by element."""
    worst = 0.0
    for name, a, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        err = (a.float() - w.float()).abs()
        tol = SSD_RTOL * float(w.abs().max())
        limit, extra = tol, ""
        if name == "y" and y_extra is not None:
            limit = tol + y_extra
            extra = " + 2^-7 |want| + 2^-8 y(|x|, |B|, |C|)"
        _log(f"[kernels] {label} {name}: max_abs_err {float(err.max()):.3g} "
             f"(tol {tol:.3g} = {SSD_RTOL} x max |want| "
             f"{float(w.abs().max()):.3g}{extra})")
        if not (bool((err <= limit).all()) and torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name} disagrees with its plain "
                                 f"version")
        worst = max(worst, float(err.max()))
    return worst


def _check_ssd_batch_invariance(args):
    """Batch row 0 alone, and chunk (0, 5) alone, give the bits they give
    in the whole call: each chunk's work is its own CTAs'."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    full = ssd_chunk_cuda(*args)
    for label, idx in (("batch row 0", (slice(0, 1),)),
                       ("chunk (0, 5)", (slice(0, 1), slice(5, 6)))):
        alone = ssd_chunk_cuda(*(a[idx] for a in args))
        same = all(torch.equal(p, f[idx]) for p, f in zip(alone, full))
        _log(f"[kernels] ssd_chunk {label} alone vs in the batch: "
             f"{'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"ssd_chunk {label} alone differs from it "
                                 f"in the batch")


def phase_forward_kernels():
    """Flash attention and the SSD chunk against their plain versions at
    the forward path's shapes, then timed."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import flash_attention_plain, ssd_chunk_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    flash_err = 0.0
    # the last two: S = 1000 is no multiple of a CTA's flattened rows or
    # of the 32-key tile
    for s, causal, window, dt in ((FS, True, 0, torch.float32),
                                  (FS, True, 1024, torch.float32),
                                  (1024, False, 0, torch.float32),
                                  (FS, True, 0, torch.bfloat16),
                                  (1000, True, 0, torch.float32),
                                  (1000, False, 300, torch.float32)):
        q, k, v = _flash_inputs(FB, s, dt)
        p_round = None
        if dt == torch.bfloat16:  # rows near the start see few keys
            p_round = 2.0 ** -8 * flash_attention_plain(
                q, k, v.abs(), causal=causal, window=window)
        err = _check(f"flash_attention S={s} causal={causal} "
                     f"window={window} {dt}",
                     flash_attention_cuda(q, k, v, causal=causal,
                                          window=window),
                     flash_attention_plain(q, k, v, causal=causal,
                                           window=window), dt, p_round)
        if dt == torch.float32:
            flash_err = max(flash_err, err)
        del q, k, v, p_round
    ssd_err = 0.0
    # mamba2's phase 3c shape, the prefill's (B=4, NC=8), G > 1, and a
    # chunk of 160 positions with ds = 96 (a partial row block of 32 rows
    # and a partial state slice of 32 rows)
    for shape in (SSD, dict(SSD, B=4, NC=8),
                  dict(SSD, B=1, NC=4, NH=16, G=2, DS=64),
                  dict(SSD, B=1, NC=4, NH=16, G=2, Q=160, DS=96)):
        args = _ssd_inputs(*shape.values())
        ssd_err = max(ssd_err, _check_ssd(
            f"ssd_chunk {shape}", ssd_chunk_cuda(*args),
            ssd_chunk_plain(*args)))
    _check_ssd_batch_invariance(_ssd_inputs(*SSD.values()))
    zargs = _ssd_inputs(*SSD_ZAMBA2.values())
    zamba2_err = _check_ssd(f"ssd_chunk {SSD_ZAMBA2} (zamba2)",
                            ssd_chunk_cuda(*zargs), ssd_chunk_plain(*zargs))
    _check_ssd_batch_invariance(zargs)
    bf16 = _ssd_inputs(*SSD.values(), dtype=torch.bfloat16)
    x, b, c, dt, cum = bf16
    y_abs = ssd_chunk_plain(x.abs().float(), b.abs().float(),
                            c.abs().float(), dt, cum)[0]
    want = ssd_chunk_plain(*bf16)
    _check_ssd(f"ssd_chunk {SSD} bf16", ssd_chunk_cuda(*bf16), want,
               BF16_ULP * want[0].float().abs() + SSD_BF16_ATT * y_abs)
    _check_ssd_batch_invariance(bf16)
    del y_abs, want, x, b, c, dt, cum
    torch.cuda.synchronize()

    rows = []
    q, k, v = _flash_inputs(FB, FS, torch.float32)
    bound = _flash_bound_ms(q, k, True, 0)
    kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qt = q.transpose(1, 2)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kx, vx, is_causal=True))
    rows.append(_timed_row(
        "flash_attention", lambda: flash_attention_cuda(q, k, v),
        lambda: flash_attention_plain(q, k, v), lib_ms, bound,
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:83", flash_err))
    del q, k, v, kx, vx, qt
    args = _ssd_inputs(*SSD.values())
    bound = _ssd_bound_ms(args[0], args[1])
    _log(f"[kernels] ssd_chunk f32 bound on the CUDA cores (the PR 13 "
         f"design's): {_ssd_bound_ms(args[0], args[1], True)[0]:.4f} ms")
    rows.append(_timed_row(
        "ssd_chunk", lambda: ssd_chunk_cuda(*args),
        lambda: ssd_chunk_plain(*args), None, bound,
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:54", ssd_err))
    row = _timed_row(
        "ssd_chunk_zamba2", lambda: ssd_chunk_cuda(*zargs),
        lambda: ssd_chunk_plain(*zargs), None,
        _ssd_bound_ms(zargs[0], zargs[1]),
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:54", zamba2_err)
    row["shape"] = str(SSD_ZAMBA2)
    rows.append(row)
    del zargs
    # the bf16 instance, timed for the record (not on the served path)
    bound, bound_by, rate = _ssd_bound_ms(bf16[0], bf16[1])
    _log(f"[kernels] ssd_chunk bf16: "
         f"{_time_ms(lambda: ssd_chunk_cuda(*bf16)):.4f} ms (plain "
         f"{_time_ms(lambda: ssd_chunk_plain(*bf16)):.4f} ms, bound "
         f"{bound:.4f} ms by {bound_by}; flops at {rate})")
    return rows


def _timed_prefill(run, label, n=2):
    """Host clock around ``run`` ending in a synchronize, ``n`` times."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _log(f"[forward] {label}: {', '.join(f'{t:.1f}' for t in times)} ms")
    return times


def _check_logits(label, got, want, tol=LOGIT_TOL):
    err = float((got - want).abs().max())
    _log(f"[forward] {label}: max_abs_err {err:.3g} (tol {tol}); |logits| "
         f"max {float(want.abs().max()):.3g}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{label}: logits disagree")
    return err


def phase_forward_attention(model, params, fb=FB, fs=FS):
    """``model``'s batched whole-prompt prefill (fb x fs) through flash
    attention: one launch per layer, last-row logits against the plain
    path and (without MoE) against the dense engine's chunked prefill;
    with MoE the drop fraction of the prefill is printed.  Timed and
    profiled."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.runtime.steps import make_prefill_step

    cfg = model.cfg
    name = cfg.name
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(fb, fs)),
                           device="cuda")
    batch = {"tokens": toks}
    step = make_prefill_step(model)
    flash_attention_cuda.launches = 0
    first, caches = step(params, batch)
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    _log(f"[forward] {name} prefill step {fb} x {fs}: flash_attention "
         f"launches {launches}; first tokens {first.ravel().tolist()}; "
         f"cache k {tuple(_pools(caches)['k'].shape)}")
    if launches != cfg.num_layers:
        raise AssertionError(f"flash attention launched {launches} times, "
                             f"not once per layer ({cfg.num_layers})")
    if first.shape != (fb, 1) or not bool(((first >= 0) & (
            first < cfg.vocab_size)).all()):
        raise AssertionError("prefill tokens outside the vocabulary")
    del caches
    logits, _ = model.prefill(params, batch)
    with _plain_attention():
        want, _ = model.prefill(params, batch)
    _check_logits(f"{name} prefill logits, kernel vs plain", logits, want)
    del want
    if cfg.moe is not None:
        # the engine's 256-token chunks dispatch at another capacity than
        # the whole prompt's 512-token chunks, so the two routes may drop
        # other choices: no chunked-prefill comparison for MoE
        _, aux, _ = model.hidden(params, batch, mode="prefill")
        _log(f"[forward] {name} prefill {fb} x {fs}: MoE drop fraction "
             f"{float(aux['moe_drop_frac']) / cfg.num_layers:.6f} (mean "
             f"over {cfg.num_layers} layers), lb loss "
             f"{float(aux['moe_lb_loss']) / cfg.num_layers:.4f}")
        del aux
    else:
        # the dense engine's route: one slot's chunked prefill of prompt 0
        from repro_torch.runtime.steps import compiled_step

        chunk_step = compiled_step(model, "prefill_chunk")
        dense = model.init_cache(1, fs)
        for off in range(0, fs, CHUNK):
            _, dense = chunk_step(params, dense, toks[:1, off:off + CHUNK],
                                  0, off)
        last, _ = model.prefill_chunk_step(params, dense,
                                           toks[:1, fs - CHUNK:], 0,
                                           fs - CHUNK)
        _check_logits(f"{name} prefill vs the engine's chunked prefill "
                      f"(prompt 0, last row)", logits[:1], last[-1:])
        del dense
    times = _timed_prefill(functools.partial(step, params, batch),
                           f"{name} prefill step {fb} x {fs}")
    _profile_tick(functools.partial(step, params, batch),
                  f"{name} prefill step {fb} x {fs}", ticks=1, top=10)
    return launches, times


def make_ssm_model():
    from repro_torch.configs import get_config
    from repro_torch.models import LM, RuntimeKnobs

    cfg = get_config("mamba2-1.3b")
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32), device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    _log(f"[ssm] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
         f"ssm {cfg.ssm} vocab {cfg.vocab_size}; init "
         f"{time.perf_counter() - t0:.1f}s")
    return model, params


def phase_ssm(model, params):
    """mamba2-1.3b: batched prefill through the SSD kernel, decode from its
    states, the token-fed route, and the engine."""
    from repro_torch.kernels.ops import ssd_chunk_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    cfg = model.cfg
    rng = np.random.default_rng(4)
    sb, ss = 4, 2048
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(sb, ss)),
                           device="cuda")
    batch = {"tokens": toks}
    step = make_prefill_step(model)
    ssd_chunk_cuda.launches = 0
    nxt, caches = step(params, batch)
    torch.cuda.synchronize()
    launches = ssd_chunk_cuda.launches
    _log(f"[ssm] prefill step {sb} x {ss}: ssd_chunk launches {launches}; "
         f"conv {tuple(caches['stack']['conv'].shape)} state "
         f"{tuple(caches['stack']['state'].shape)}; |state| max "
         f"{float(caches['stack']['state'].abs().max()):.3g}")
    if launches != cfg.num_layers:
        raise AssertionError(f"SSD kernel launched {launches} times, not "
                             f"once per layer ({cfg.num_layers})")
    with _first_call_args("ssd_chunk") as seen:
        logits, _ = model.prefill(params, batch)
    # the first layer's own SSD inputs (strided views of its in_proj
    # output) through the kernel and the plain version
    _check_ssd("ssd_chunk, mamba2 prefill layer 0",
               ssd_chunk_cuda(*seen[0]), ssd_chunk_plain(*seen[0]))
    del seen
    with _plain_attention():
        want, _ = model.prefill(params, batch)
    _check_logits("mamba2 prefill logits, kernel vs plain", logits, want)
    del want
    # 32 greedy decode steps from the prefill's states
    serve = make_serve_step(model)
    out = [nxt]
    for i in range(32):
        nxt, caches = serve(params, caches, nxt, ss + i)
        out.append(nxt)
    stream = torch.cat(out, 1)
    if not bool(((stream >= 0) & (stream < cfg.vocab_size)).all()):
        raise AssertionError("decode tokens outside the vocabulary")
    _log(f"[ssm] 32 decode steps after the prefill: slot 0 tokens "
         f"{stream[0, :12].tolist()}...")
    tick_ms = [_time_ms(functools.partial(serve, params, caches, nxt, ss),
                        iters=10, warmup=2, queued=False) for _ in range(3)]
    _log(f"[ssm] decode tick, batch {sb}: "
         f"{', '.join(f'{t:.3f}' for t in tick_ms)} ms (median of 10 each)")
    _profile_tick(functools.partial(serve, params, caches, nxt, ss),
                  f"mamba2 decode tick batch {sb}")
    del caches

    # one ~128-token prompt: prefill then decode against the token feed
    # the engine runs (decode steps from a zeroed slot)
    prompt = toks[:1, :128]
    n_new = 8
    lp, pc = model.prefill(params, {"tokens": prompt})
    fed = model.init_cache(1, 256)
    for t in range(128):
        lf, fed = model.decode_step(params, fed, prompt[:, t:t + 1], t)
    errs = [_check_logits("mamba2 128-token prompt: prefill vs token feed",
                          lp, lf, SSM_FEED_TOL)]
    pref = [int(lp.argmax())]
    for i in range(n_new - 1):
        tok = torch.tensor([[pref[-1]]], device="cuda")
        lp, pc = model.decode_step(params, pc, tok, 128 + i)
        lf, fed = model.decode_step(params, fed, tok, 128 + i)
        errs.append(float((lp - lf).abs().max()))
        pref.append(int(lp.argmax()))
    _log(f"[ssm] prefill-then-decode vs token-fed logits over {n_new} "
         f"steps: max_abs_err {max(errs):.3g} (tol {SSM_FEED_TOL})")
    if max(errs) > SSM_FEED_TOL:
        raise AssertionError("prefill-then-decode and token-fed logits "
                             "disagree")
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=256))
    h = eng.submit(Request(0, prompt[0].cpu().numpy().astype(np.int32),
                           max_new_tokens=n_new))
    eng.run()
    _log(f"[ssm] engine (token-fed) tokens {h.req.output}; prefill-then-"
         f"decode {pref}")
    if h.req.output != pref:
        raise AssertionError("the engine's tokens differ from "
                             "prefill-then-decode")

    # the engine: more requests than slots, then wave mode
    reqs = [(i, rng.integers(0, cfg.vocab_size, size=int(n)).astype(
        np.int32)) for i, n in enumerate((20, 7, 31, 12, 25, 9))]
    eng = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=128))
    handles = [eng.submit(Request(i, p, max_new_tokens=8)) for i, p in reqs]
    done = eng.run()
    # a correctness run: too few and too short requests to time serving
    _log(f"[ssm] engine continuous: {len(done)}/6 requests, "
         f"{sum(len(r.output) for r in done)} tokens")
    if len(done) != 6 or any(len(r.output) != 8 for r in done):
        raise AssertionError("mamba2 continuous run did not finish")
    # the last request was admitted into a reused slot: alone, in a fresh
    # engine, it must give the same tokens
    solo = ServeEngine(model, params, ServeConfig(batch_slots=4,
                                                  max_len=128))
    hs = solo.submit(Request(5, reqs[5][1], max_new_tokens=8))
    solo.run()
    _log(f"[ssm] reused slot vs fresh engine: {handles[5].req.output} vs "
         f"{hs.req.output}")
    if hs.req.output != handles[5].req.output:
        raise AssertionError("a reused slot's tokens differ from a fresh "
                             "engine's")
    wave = ServeEngine(model, params, ServeConfig(batch_slots=4, max_len=128,
                                                  mode="wave"))
    for i, p in reqs:
        wave.submit(Request(i, p, max_new_tokens=8))
    wdone = wave.run()
    _log(f"[ssm] engine wave: {len(wdone)}/6 requests; streams equal to "
         f"continuous: "
         f"{sorted((r.req_id, r.output) for r in wdone) == sorted((r.req_id, r.output) for r in done)}")
    if len(wdone) != 6:
        raise AssertionError("mamba2 wave run did not finish")

    times = _timed_prefill(functools.partial(step, params, batch),
                           f"mamba2 prefill step {sb} x {ss}")
    _profile_tick(functools.partial(step, params, batch),
                  f"mamba2 prefill step {sb} x {ss}", ticks=1, top=10)
    return launches, times


# ------------------------------------------ 3g: kernels at new groupings
# (H, KV) of the MoE archs' attention: mixtral 32/8 (G = 4: one token is
# the chunked decode kernel's 8-row instance, the T = 4 verify block its
# 16-row one, the many-row kernel 16 positions of 4 heads per tile) and
# qwen3-moe 64/4 (G = 16: one token is the 16-row instance, the many-row
# kernel 4 positions of 16 heads); the served windows 1024 (gemma3's local
# layers) and 4096 (mixtral's)
GROUPINGS = ((32, 8), (64, 4))
WINDOWS_G = (0, 1024, 4096)


@contextlib.contextmanager
def _heads(h, kv, d=None):
    """Run the kernel helpers of phases 3 and 3c at ``h`` query and ``kv``
    KV heads and head dim ``d`` (default: unchanged; they read the
    module's H, KV and D)."""
    global H, KV, D
    old = H, KV, D
    H, KV, D = h, kv, d or D
    try:
        yield
    finally:
        H, KV, D = old


def _grouping_checks(g):
    """The decode, split-K, paged prefill and flash kernels at H, KV
    against their plain versions; a slot alone against the batch."""
    from repro_torch.kernels.decode_attention import (
        MAX_ROWS, decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         flash_attention_plain,
                                         paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    f32 = torch.float32
    # the blocks one instance holds; past it (G = 16 at T = 4) the rows go
    # in row tiles, held here once and in full by phase 3r
    ts = tuple(t for t in (1, VERIFY_T) if g * t <= MAX_ROWS)
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for positions in (POS, POS_EDGES):
        for window in WINDOWS_G:
            for t in ts:
                q, k, v, pos = _inputs(t, f32, f32, positions=positions)
                note(f"decode_attention_t{t}", _check(
                    f"decode_attention H={H} KV={KV} T={t} "
                    f"pos={positions} window={window}",
                    decode_attention_cuda(q, k, v, pos, window=window),
                    decode_attention_plain(q, k, v, pos, window=window),
                    f32))
                q, k, v, table, pos = _paged_inputs(t, f32, f32,
                                                    positions=positions)
                note(f"paged_decode_attention_t{t}", _check(
                    f"paged_decode_attention H={H} KV={KV} T={t} "
                    f"pos={positions} window={window}",
                    paged_decode_attention_cuda(q, k, v, table, pos,
                                                window=window),
                    paged_decode_attention_plain(q, k, v, table, pos,
                                                 window=window), f32))
            q, k, v, pos = _inputs(1, f32, f32, positions=positions)
            one = decode_attention_cuda(q, k, v, pos, window=window)
            got = decode_attention_splitk_cuda(q, k, v, pos, window=window,
                                               num_splits=2)
            note("decode_attention_splitk", _check(
                f"decode_attention_splitk H={H} KV={KV} ns=2 "
                f"pos={positions} window={window}", got,
                decode_attention_plain(q, k, v, pos, window=window,
                                       num_splits=2), f32))
            if not torch.equal(got, one):
                raise AssertionError("dense split-K with whole-chunk splits "
                                     "differs from the single pass")
            q, k, v, table, pos = _paged_inputs(1, f32, f32,
                                                positions=positions)
            note("paged_decode_attention_splitk", _check(
                f"paged_decode_attention_splitk H={H} KV={KV} ns=2 "
                f"pos={positions} window={window}",
                paged_decode_attention_splitk_cuda(q, k, v, table, pos,
                                                   window=window,
                                                   num_splits=2),
                paged_decode_attention_plain(q, k, v, table, pos,
                                             window=window, num_splits=2),
                f32))
    if g * VERIFY_T > MAX_ROWS:  # the verify block in row tiles
        q, k, v, pos = _inputs(VERIFY_T, f32, f32)
        _check(f"decode_attention H={H} KV={KV} T={VERIFY_T} "
               f"({g * VERIFY_T} rows, row tiles)",
               decode_attention_cuda(q, k, v, pos),
               decode_attention_plain(q, k, v, pos), f32)

    def dense(t, positions):
        q, k, v, pos = _inputs(t, f32, f32, positions=positions)
        return (q, k, v, pos), (q[3:], k[3:], v[3:], pos[3:])

    def paged(t, positions):
        q, k, v, table, pos = _paged_inputs(t, f32, f32, positions=positions)
        return (q, k, v, table, pos), (q[3:], k, v, table[3:], pos[3:])

    _check_slot_alone("decode_attention", dense, decode_attention_cuda,
                      decode_attention_splitk_cuda, ts)
    _check_slot_alone("paged_decode_attention", paged,
                      paged_decode_attention_cuda,
                      paged_decode_attention_splitk_cuda, ts)
    slot = B - 1
    for c, q_offset, window in ((CHUNK, 0, 0), (CHUNK, S // 2 - CHUNK, 0),
                                (CHUNK, S // 2 - CHUNK, 4096),
                                (RAGGED, S // 2, 0), (RAGGED, S // 2, 4096),
                                (RAGGED, S // 2, 1024)):
        q, k, v, table, _ = _paged_inputs(1, f32, f32, chunk=c)
        note("paged_prefill_attention", _check(
            f"paged_prefill_attention H={H} KV={KV} C={c} "
            f"q_offset={q_offset} window={window}",
            paged_prefill_attention_cuda(q, k, v, table[slot], q_offset,
                                         window=window),
            paged_prefill_attention_plain(q, k, v, table, slot, q_offset,
                                          window=window), f32))
    for s, causal, window in ((FS, True, 0), (FS, True, 4096),
                              (FS, True, 1024), (1000, True, 300)):
        q, k, v = _flash_inputs(FB, s, f32)
        note("flash_attention", _check(
            f"flash_attention H={H} KV={KV} S={s} causal={causal} "
            f"window={window}",
            flash_attention_cuda(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window),
            f32))
        del q, k, v
    torch.cuda.synchronize()
    return errs, ts


def phase_grouping_kernels():
    """Phase 3g: #1-#6 at mixtral's and qwen3-moe's head groupings under
    windows 0, 1024 and 4096, against their plain versions, then timed as
    in phase 3 (bound and one SDPA call).  The rows are keyed by the
    grouping: ``<kernel>_g<G>`` (and ``_verify`` for the T = 4 block)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         flash_attention_plain,
                                         paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    dense_src = "src/repro_torch/kernels/csrc/decode_attention.cu"
    paged_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    dec_line = "src/repro/kernels/decode_attention.py"
    pag_line = "src/repro/kernels/paged_attention.py"
    f32 = torch.float32
    rows = []
    for h, kv in GROUPINGS:
        g = h // kv
        with _heads(h, kv):
            errs, ts = _grouping_checks(g)
            for t in ts:
                suffix = f"_g{g}" + ("_verify" if t > 1 else "")
                q, k, v, pos = _inputs(t, f32, f32)
                rows.append(_timed_row(
                    f"decode_attention{suffix}",
                    lambda: decode_attention_cuda(q, k, v, pos),
                    lambda: decode_attention_plain(q, k, v, pos),
                    _time_ms(_library_call(q, k, v, pos)),
                    _bound_ms(q, k, pos), dense_src, f"{dec_line}:131",
                    errs[f"decode_attention_t{t}"]))
                q, k, v, table, pos = _paged_inputs(t, f32, f32)
                rows.append(_timed_row(
                    f"paged_decode_attention{suffix}",
                    lambda: paged_decode_attention_cuda(q, k, v, table, pos),
                    lambda: paged_decode_attention_plain(q, k, v, table,
                                                         pos),
                    _time_ms(_paged_library_call(q, k, v, table, pos)),
                    _bound_ms(q, k, pos, paged=True), paged_src,
                    f"{pag_line}:131", errs[f"paged_decode_attention_t{t}"]))
            q, k, v, pos = _inputs(1, f32, f32)
            rows.append(_timed_row(
                f"decode_attention_splitk_g{g}",
                lambda: decode_attention_splitk_cuda(q, k, v, pos,
                                                     num_splits=2),
                lambda: decode_attention_plain(q, k, v, pos, num_splits=2),
                _time_ms(_library_call(q, k, v, pos)), _bound_ms(q, k, pos),
                dense_src, f"{dec_line}:236",
                errs["decode_attention_splitk"]))
            q, k, v, table, pos = _paged_inputs(1, f32, f32)
            rows.append(_timed_row(
                f"paged_decode_attention_splitk_g{g}",
                lambda: paged_decode_attention_splitk_cuda(
                    q, k, v, table, pos, num_splits=2),
                lambda: paged_decode_attention_plain(q, k, v, table, pos,
                                                     num_splits=2),
                _time_ms(_paged_library_call(q, k, v, table, pos)),
                _bound_ms(q, k, pos, paged=True), paged_src,
                f"{pag_line}:325", errs["paged_decode_attention_splitk"]))
            q_offset, slot = S // 2 - CHUNK, B - 1
            q, k, v, table, _ = _paged_inputs(1, f32, f32, chunk=CHUNK)
            rows.append(_timed_row(
                f"paged_prefill_attention_g{g}",
                lambda: paged_prefill_attention_cuda(q, k, v, table[slot],
                                                     q_offset),
                lambda: paged_prefill_attention_plain(q, k, v, table, slot,
                                                      q_offset),
                _time_ms(_prefill_library_call(q, k, v, table[slot],
                                               q_offset)),
                _prefill_bound_ms(q, k, q_offset), paged_src,
                f"{pag_line}:228", errs["paged_prefill_attention"]))
            q, k, v = _flash_inputs(FB, FS, f32)
            qt = q.transpose(1, 2)
            kx = k.transpose(1, 2).repeat_interleave(g, dim=1)
            vx = v.transpose(1, 2).repeat_interleave(g, dim=1)
            rows.append(_timed_row(
                f"flash_attention_g{g}", lambda: flash_attention_cuda(q, k, v),
                lambda: flash_attention_plain(q, k, v),
                _time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kx, vx, is_causal=True)),
                _flash_bound_ms(q, k, True, 0),
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:83",
                errs["flash_attention"]))
            del q, k, v, qt, kx, vx
            for row in rows[-(2 * len(ts) + 4):]:
                row["grouping"] = f"H={h} KV={kv}"
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------ 3h: kernels at head dims 80, 64
# zamba2-2.7b's shared attention block (2560 / 32 = 80) and musicgen-large
# (2048 / 32 = 64), both H = KV = 32 (G = 1): one token is the chunked
# decode kernel's 2-row instance and the T = 4 verify block its 8-row one
# (the only instances these head dims have); the many-row kernel holds 64
# positions of one head per tile.  Each head dim is its own library.
HEAD_DIM_CASES = (80, 64)
WINDOWS_H = (0, 1024)
H_HD = 32


def _head_dim_checks(d):
    """#1-#6 at head dim ``d`` (H = KV = 32) against their plain versions:
    f32 at both position sets, windows 0 and 1024, T = 1 and 4; split-K at
    2, 4 and 8 splits bitwise the single pass; a slot alone against the
    batch and the rows of a T = 4 block against the T = 1 launches,
    bitwise; #4 and #6 at the new tiles' edges; bf16 caches and pools, and
    int8 and fp8 pools.  Returns the worst f32 error per kernel."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         flash_attention_plain,
                                         paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}

    def note(name, err, kd=f32):
        if kd == f32:
            errs[name] = max(errs.get(name, 0.0), err)

    for positions in (POS, POS_EDGES):
        for window in WINDOWS_H:
            for t in (1, VERIFY_T):
                for kd in (f32, bf16):
                    q, k, v, pos = _inputs(t, f32, kd, positions=positions)
                    note("decode_attention", _check(
                        f"decode_attention D={D} T={t} pos={positions} "
                        f"window={window} cache={kd}",
                        decode_attention_cuda(q, k, v, pos, window=window),
                        decode_attention_plain(q, k, v, pos, window=window),
                        kd), kd)
                    q, k, v, table, pos = _paged_inputs(
                        t, f32, kd, positions=positions)
                    note("paged_decode_attention", _check(
                        f"paged_decode_attention D={D} T={t} "
                        f"pos={positions} window={window} pool={kd}",
                        paged_decode_attention_cuda(q, k, v, table, pos,
                                                    window=window),
                        paged_decode_attention_plain(q, k, v, table, pos,
                                                     window=window), kd),
                        kd)
            q, k, v, pos = _inputs(1, f32, f32, positions=positions)
            one = decode_attention_cuda(q, k, v, pos, window=window)
            for ns in (2, 4, 8):
                got = decode_attention_splitk_cuda(q, k, v, pos,
                                                   window=window,
                                                   num_splits=ns)
                note("decode_attention_splitk", _check(
                    f"decode_attention_splitk D={D} ns={ns} "
                    f"pos={positions} window={window}", got,
                    decode_attention_plain(q, k, v, pos, window=window,
                                           num_splits=ns), f32))
                if not torch.equal(got, one):
                    raise AssertionError(f"dense split-K at D={D}, {ns} "
                                         f"splits, differs from the single "
                                         f"pass")
            q, k, v, table, pos = _paged_inputs(1, f32, f32,
                                                positions=positions)
            note("paged_decode_attention_splitk", _check(
                f"paged_decode_attention_splitk D={D} ns=2 "
                f"pos={positions} window={window}",
                paged_decode_attention_splitk_cuda(q, k, v, table, pos,
                                                   window=window,
                                                   num_splits=2),
                paged_decode_attention_plain(q, k, v, table, pos,
                                             window=window, num_splits=2),
                f32))
        _log(f"[kernels] decode_attention_splitk D={D} pos={positions}: 2, "
             f"4 and 8 splits equal the single pass bitwise")
        # bf16 q (and output) on bf16 caches and pools
        for t in (1, VERIFY_T):
            q, k, v, pos = _inputs(t, bf16, bf16, positions=positions)
            _check(f"decode_attention D={D} T={t} pos={positions} q=bf16 "
                   f"cache=bf16", decode_attention_cuda(q, k, v, pos),
                   decode_attention_plain(q, k, v, pos), bf16)
            q, k, v, table, pos = _paged_inputs(t, bf16, bf16,
                                                positions=positions)
            _check(f"paged_decode_attention D={D} T={t} pos={positions} "
                   f"q=bf16 pool=bf16",
                   paged_decode_attention_cuda(q, k, v, table, pos),
                   paged_decode_attention_plain(q, k, v, table, pos), bf16)
        # the quantized pools' scale branch: T = 1 and 4, split-K 2
        for name in QUANT:
            for t, ns in ((1, 1), (VERIFY_T, 1), (1, 2)):
                q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                    t, name, positions=positions)
                sc = dict(k_scale=ks, v_scale=vs)
                got = (paged_decode_attention_cuda(q, k, v, table, pos, **sc)
                       if ns == 1 else paged_decode_attention_splitk_cuda(
                           q, k, v, table, pos, num_splits=ns, **sc))
                note(f"paged_decode_attention{'_splitk' * (ns > 1)}_{name}",
                     _check(f"paged_decode_attention D={D} T={t} ns={ns} "
                            f"pos={positions} pool={name}", got,
                            paged_decode_attention_plain(
                                q, k, v, table, pos, num_splits=ns, **sc),
                            k.dtype))

    def dense(t, positions):
        q, k, v, pos = _inputs(t, f32, f32, positions=positions)
        return (q, k, v, pos), (q[3:], k[3:], v[3:], pos[3:])

    def paged(t, positions):
        q, k, v, table, pos = _paged_inputs(t, f32, f32, positions=positions)
        return (q, k, v, table, pos), (q[3:], k, v, table[3:], pos[3:])

    _check_slot_alone("decode_attention", dense, decode_attention_cuda,
                      decode_attention_splitk_cuda, (1, VERIFY_T))
    _check_slot_alone("paged_decode_attention", paged,
                      paged_decode_attention_cuda,
                      paged_decode_attention_splitk_cuda, (1, VERIFY_T))
    # the verify block's rows (the 8-row instance) bitwise the T = 1
    # launches (the 2-row instance) at pos + t, across chunk boundaries
    for positions in (POS_V, POS_V_EDGES):
        for window in WINDOWS_H:
            q, k, v, pos = _inputs(VERIFY_T, f32, f32, positions=positions)
            _rows_alone(f"decode_attention D={D} pos={positions} "
                        f"window={window}",
                        lambda qq, p, a: decode_attention_cuda(
                            qq, k, v, p, active=a, window=window), q, pos)
            q, k, v, table, pos = _paged_inputs(VERIFY_T, f32, f32,
                                                positions=positions)
            _rows_alone(f"paged_decode_attention D={D} pos={positions} "
                        f"window={window}",
                        lambda qq, p, a: paged_decode_attention_cuda(
                            qq, k, v, table, p, active=a, window=window),
                        q, pos)
        q, k, v, ks, vs, table, pos = _quant_paged_inputs(
            VERIFY_T, "int8", positions=positions)
        _rows_alone(f"paged_decode_attention D={D} int8 pos={positions}",
                    lambda qq, p, a: paged_decode_attention_cuda(
                        qq, k, v, table, p, active=a, k_scale=ks,
                        v_scale=vs), q, pos)
    slot = B - 1
    for c, q_offset, window in ((CHUNK, 0, 0), (CHUNK, S // 2 - CHUNK, 0),
                                (CHUNK, S // 2 - CHUNK, 1024),
                                (RAGGED, S // 2, 0), (RAGGED, S // 2, 1024)):
        for kd in (f32, bf16):
            q, k, v, table, _ = _paged_inputs(1, f32, kd, chunk=c)
            p_round = None
            if kd == bf16:
                p_round = 2.0 ** -8 * paged_prefill_attention_plain(
                    q, k, v.abs(), table, slot, q_offset, window=window)
            note("paged_prefill_attention", _check(
                f"paged_prefill_attention D={D} C={c} q_offset={q_offset} "
                f"window={window} pool={kd}",
                paged_prefill_attention_cuda(q, k, v, table[slot], q_offset,
                                             window=window),
                paged_prefill_attention_plain(q, k, v, table, slot, q_offset,
                                              window=window), kd, p_round),
                kd)
        for name in QUANT:
            q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name, chunk=c)
            sc = dict(k_scale=ks, v_scale=vs, window=window)
            note(f"paged_prefill_attention_{name}", _check(
                f"paged_prefill_attention D={D} C={c} q_offset={q_offset} "
                f"window={window} pool={name}",
                paged_prefill_attention_cuda(q, k, v, table[slot], q_offset,
                                             **sc),
                paged_prefill_attention_plain(q, k, v, table, slot, q_offset,
                                              **sc), k.dtype))
    for s, causal, window, dt in ((FS, True, 0, f32), (FS, True, 1024, f32),
                                  (1000, True, 300, f32),
                                  (1000, False, 300, f32),
                                  (1000, True, 0, bf16)):
        q, k, v = _flash_inputs(FB, s, dt)
        p_round = None
        if dt == bf16:
            p_round = 2.0 ** -8 * flash_attention_plain(
                q, k, v.abs(), causal=causal, window=window)
        note("flash_attention", _check(
            f"flash_attention D={D} S={s} causal={causal} window={window} "
            f"{dt}", flash_attention_cuda(q, k, v, causal=causal,
                                          window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window), dt,
            p_round), dt)
        del q, k, v, p_round
    torch.cuda.synchronize()
    return errs


def _check_head_dim_refusals():
    """A head dim no library is built for raises by name before any
    launch; more query rows than the head dim's largest instance (16 at
    head dim 80) launch in row tiles and hold to the plain version."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      max_rows)
    from repro_torch.kernels.ops import decode_attention_plain

    f32 = torch.float32
    with _heads(H_HD, H_HD, 96):
        q, k, v, pos = _inputs(1, f32, f32)
        before = decode_attention_cuda.launches
        try:
            decode_attention_cuda(q, k, v, pos)
        except ValueError as e:
            if "head_dim 96 not built" not in str(e) or \
                    decode_attention_cuda.launches != before:
                raise
            _log(f"[kernels] decode_attention D=96: refused as it must be "
                 f"({e})")
        else:
            raise AssertionError("D=96 was not refused")
        del q, k, v
    with _heads(H_HD, H_HD, 80):
        t = 2 * max_rows(80)
        q, k, v, pos = _inputs(t, f32, f32)
        _check(f"decode_attention D=80 T={t} (row tiles)",
               decode_attention_cuda(q, k, v, pos),
               decode_attention_plain(q, k, v, pos), f32)
        del q, k, v
    torch.cuda.empty_cache()


def phase_head_dim_kernels():
    """Phase 3h: #1-#6 at head dims 80 and 64 (H = KV = 32) against their
    plain versions, the refusals, then each timed as in phase 3 with its
    bound and one SDPA call.  Rows ``<kernel>_d<D>``: at D = 80 the
    kernels zamba2's path runs (#1, #2, #6), at D = 64 musicgen's (#1-#6,
    and #3-#5 on int8 pools); the other kernels' times are printed."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         flash_attention_plain,
                                         paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)
    from repro_torch.models.attention import dequantize_kv

    dense_src = "src/repro_torch/kernels/csrc/decode_attention.cu"
    paged_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    dec_line = "src/repro/kernels/decode_attention.py"
    pag_line = "src/repro/kernels/paged_attention.py"
    on_path = {80: ("decode_attention", "decode_attention_splitk",
                    "flash_attention")}
    f32 = torch.float32
    _check_head_dim_refusals()
    rows = []
    for d in HEAD_DIM_CASES:
        with _heads(H_HD, H_HD, d):
            errs = _head_dim_checks(d)
            slot, q_offset = B - 1, S // 2 - CHUNK
            timed = []
            q, k, v, pos = _inputs(1, f32, f32)
            lib_ms, bound = (_time_ms(_library_call(q, k, v, pos)),
                             _bound_ms(q, k, pos))
            timed += [
                ("decode_attention", lambda: decode_attention_cuda(
                    q, k, v, pos), lambda: decode_attention_plain(
                        q, k, v, pos), lib_ms, bound, dense_src,
                 f"{dec_line}:131"),
                ("decode_attention_splitk",
                 lambda: decode_attention_splitk_cuda(q, k, v, pos,
                                                      num_splits=2),
                 lambda: decode_attention_plain(q, k, v, pos, num_splits=2),
                 lib_ms, bound, dense_src, f"{dec_line}:236")]
            pq, pk, pv, table, ppos = _paged_inputs(1, f32, f32)
            lib_ms, bound = (_time_ms(_paged_library_call(pq, pk, pv, table,
                                                          ppos)),
                             _bound_ms(pq, pk, ppos, paged=True))
            timed += [
                ("paged_decode_attention",
                 lambda: paged_decode_attention_cuda(pq, pk, pv, table, ppos),
                 lambda: paged_decode_attention_plain(pq, pk, pv, table,
                                                      ppos),
                 lib_ms, bound, paged_src, f"{pag_line}:131"),
                ("paged_decode_attention_splitk",
                 lambda: paged_decode_attention_splitk_cuda(
                     pq, pk, pv, table, ppos, num_splits=2),
                 lambda: paged_decode_attention_plain(pq, pk, pv, table,
                                                      ppos, num_splits=2),
                 lib_ms, bound, paged_src, f"{pag_line}:325")]
            cq, ck, cv, ctable, _ = _paged_inputs(1, f32, f32, chunk=CHUNK)
            timed.append((
                "paged_prefill_attention",
                lambda: paged_prefill_attention_cuda(cq, ck, cv,
                                                     ctable[slot], q_offset),
                lambda: paged_prefill_attention_plain(cq, ck, cv, ctable,
                                                      slot, q_offset),
                _time_ms(_prefill_library_call(cq, ck, cv, ctable[slot],
                                               q_offset)),
                _prefill_bound_ms(cq, ck, q_offset), paged_src,
                f"{pag_line}:228"))
            iq, ik, iv, iks, ivs, itable, ipos = _quant_paged_inputs(1,
                                                                    "int8")
            isc = dict(k_scale=iks, v_scale=ivs)
            lib_ms = _time_ms(_paged_library_call(
                iq, dequantize_kv(ik, iks), dequantize_kv(iv, ivs), itable,
                ipos))
            bound = _bound_ms(iq, ik, ipos, paged=True)
            timed += [
                ("paged_decode_attention_int8",
                 lambda: paged_decode_attention_cuda(iq, ik, iv, itable,
                                                     ipos, **isc),
                 lambda: paged_decode_attention_plain(iq, ik, iv, itable,
                                                      ipos, **isc),
                 lib_ms, bound, paged_src, f"{pag_line}:131"),
                ("paged_decode_attention_splitk_int8",
                 lambda: paged_decode_attention_splitk_cuda(
                     iq, ik, iv, itable, ipos, num_splits=2, **isc),
                 lambda: paged_decode_attention_plain(
                     iq, ik, iv, itable, ipos, num_splits=2, **isc),
                 lib_ms, bound, paged_src, f"{pag_line}:325")]
            jq, jk, jv, jks, jvs, jtable, _ = _quant_paged_inputs(
                1, "int8", chunk=CHUNK)
            jsc = dict(k_scale=jks, v_scale=jvs)
            timed.append((
                "paged_prefill_attention_int8",
                lambda: paged_prefill_attention_cuda(
                    jq, jk, jv, jtable[slot], q_offset, **jsc),
                lambda: paged_prefill_attention_plain(
                    jq, jk, jv, jtable, slot, q_offset, **jsc),
                _time_ms(_prefill_library_call(
                    jq, dequantize_kv(jk, jks), dequantize_kv(jv, jvs),
                    jtable[slot], q_offset)),
                _prefill_bound_ms(jq, jk, q_offset), paged_src,
                f"{pag_line}:228"))
            fq, fk, fv = _flash_inputs(FB, FS, f32)
            qt = fq.transpose(1, 2)
            kt, vt = fk.transpose(1, 2), fv.transpose(1, 2)
            timed.append((
                "flash_attention", lambda: flash_attention_cuda(fq, fk, fv),
                lambda: flash_attention_plain(fq, fk, fv),
                _time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
                _flash_bound_ms(fq, fk, True, 0), flash_src,
                "src/repro/kernels/flash_attention.py:83"))
            for name, run, plain, lib_ms, bound, src, replaces in timed:
                row = _timed_row(f"{name}_d{d}", run, plain, lib_ms, bound,
                                 src, replaces, errs[name])
                row["shape"] = f"H=KV={H_HD}, D={d}"
                if name in on_path.get(d, (name,)):
                    rows.append(row)
                else:
                    _log(f"[kernels] {name}_d{d}: checked and timed; not on "
                         f"a path this script drives")
            del (q, k, v, pq, pk, pv, cq, ck, cv, iq, ik, iv, jq, jk, jv,
                 fq, fk, fv, qt, kt, vt, timed)
        torch.cuda.empty_cache()
    return rows


# --------------------------------------- 3r: row tiles, any grouping <= 64
# musicgen's verify block in phase 10: 9 rows a slot at G = 1, D = 64
MUSICGEN_DRAFT_K = 8
# granite-20b (H = 48, KV = 1: 48 query rows a KV head at one token, 192
# in a verify block), qwen2.5-32b (H = 40, KV = 8: G = 5), qwen3-moe's
# verify block (H = 64, KV = 4, T = 4: 64 rows) and G = 1 blocks past the
# 8-row instance at head dims 64 and 80: the chunked decode kernel's row
# tiles.  The many-row kernel (#4, #6) at G = 5 and 48, whose positions
# straddle its CTAs' flattened rows.  (label, H, KV, D, the T of the decode
# checks)
ROW_CASES = (("g48", 48, 1, 128, (1, VERIFY_T)),
             ("g5", 40, 8, 128, (1, VERIFY_T, 8)),
             ("g16", 64, 4, 128, (VERIFY_T,)),
             ("d80", 32, 32, 80, (16,)),
             ("d64", 32, 32, 64, (MUSICGEN_DRAFT_K + 1, 16)))
WINDOWS_R = (0, 1024)
# the rows of phase 3r that a model phase launches: phases 11 and 12
# (granite, qwen2.5), 8 (qwen3-moe's verify block) and 10 (musicgen)
ROW_ON_PATH = {f"{name}_{g}" for g in ("g48", "g5") for name in (
    "decode_attention", "decode_attention_splitk", "paged_decode_attention",
    "paged_decode_attention_splitk", "paged_decode_attention_int8",
    "paged_decode_attention_splitk_int8", "paged_prefill_attention",
    "paged_prefill_attention_int8", "flash_attention")} | {
    f"{name}_{g}_verify" for g in ("g48", "g5", "g16")
    for name in ("decode_attention", "paged_decode_attention")} | {
    "decode_attention_d64_t9"}


def _row_decode_checks(ts):
    """#1, #2, #3, #5 and #3q/#5q at the module's H, KV and D for each T in
    ``ts``, against their plain versions: f32 and bf16 caches and pools at
    both position sets, windows 0 and 1024; bf16 q; int8 and fp8 pools;
    split-K (T = 1) at 2, 4 and 8 splits bitwise the single pass; a slot
    alone against the batch and each row of a T > 1 block against the
    T = 1 launch at pos + t, bitwise.  Returns the worst error per (kernel,
    T), f32 caches and pools and the quantized ones."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         paged_decode_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda)

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    tag = f"H={H} KV={KV} D={D}"
    for positions in (POS, POS_EDGES):
        for window in WINDOWS_R:
            for t in ts:
                for kd in (f32, bf16):
                    q, k, v, pos = _inputs(t, f32, kd, positions=positions)
                    err = _check(
                        f"decode_attention {tag} T={t} pos={positions} "
                        f"window={window} cache={kd}",
                        decode_attention_cuda(q, k, v, pos, window=window),
                        decode_attention_plain(q, k, v, pos, window=window),
                        kd)
                    if kd == f32:
                        note(("decode_attention", t), err)
                    q, k, v, table, pos = _paged_inputs(
                        t, f32, kd, positions=positions)
                    err = _check(
                        f"paged_decode_attention {tag} T={t} "
                        f"pos={positions} window={window} pool={kd}",
                        paged_decode_attention_cuda(q, k, v, table, pos,
                                                    window=window),
                        paged_decode_attention_plain(q, k, v, table, pos,
                                                     window=window), kd)
                    if kd == f32:
                        note(("paged_decode_attention", t), err)
            if 1 not in ts:
                continue
            q, k, v, pos = _inputs(1, f32, f32, positions=positions)
            one = decode_attention_cuda(q, k, v, pos, window=window)
            for ns in (2, 4, 8):
                got = decode_attention_splitk_cuda(q, k, v, pos,
                                                   window=window,
                                                   num_splits=ns)
                note(("decode_attention_splitk", 1), _check(
                    f"decode_attention_splitk {tag} ns={ns} "
                    f"pos={positions} window={window}", got,
                    decode_attention_plain(q, k, v, pos, window=window,
                                           num_splits=ns), f32))
                if not torch.equal(got, one):
                    raise AssertionError(f"dense split-K at {tag}, {ns} "
                                         f"splits, differs from the single "
                                         f"pass")
            q, k, v, table, pos = _paged_inputs(1, f32, f32,
                                                positions=positions)
            note(("paged_decode_attention_splitk", 1), _check(
                f"paged_decode_attention_splitk {tag} ns=2 "
                f"pos={positions} window={window}",
                paged_decode_attention_splitk_cuda(q, k, v, table, pos,
                                                   window=window,
                                                   num_splits=2),
                paged_decode_attention_plain(q, k, v, table, pos,
                                             window=window, num_splits=2),
                f32))
        if 1 in ts:
            _log(f"[rows] decode_attention_splitk {tag} pos={positions}: 2, "
                 f"4 and 8 splits equal the single pass bitwise")
        for t in ts:  # bf16 q (and output) on bf16 caches and pools
            q, k, v, pos = _inputs(t, bf16, bf16, positions=positions)
            _check(f"decode_attention {tag} T={t} pos={positions} q=bf16 "
                   f"cache=bf16", decode_attention_cuda(q, k, v, pos),
                   decode_attention_plain(q, k, v, pos), bf16)
            q, k, v, table, pos = _paged_inputs(t, bf16, bf16,
                                                positions=positions)
            _check(f"paged_decode_attention {tag} T={t} pos={positions} "
                   f"q=bf16 pool=bf16",
                   paged_decode_attention_cuda(q, k, v, table, pos),
                   paged_decode_attention_plain(q, k, v, table, pos), bf16)
        for name in QUANT:  # the scale branch
            for t, ns in [(t, 1) for t in ts] + [(1, 2)] * (1 in ts):
                q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                    t, name, positions=positions)
                sc = dict(k_scale=ks, v_scale=vs)
                got = (paged_decode_attention_cuda(q, k, v, table, pos, **sc)
                       if ns == 1 else paged_decode_attention_splitk_cuda(
                           q, k, v, table, pos, num_splits=ns, **sc))
                split = "_splitk" * (ns > 1)
                note((f"paged_decode_attention{split}_{name}", t), _check(
                    f"paged_decode_attention{split} {tag} T={t} "
                    f"pos={positions} pool={name}", got,
                    paged_decode_attention_plain(q, k, v, table, pos,
                                                 num_splits=ns, **sc),
                    k.dtype))

    def dense(t, positions):
        q, k, v, pos = _inputs(t, f32, f32, positions=positions)
        return (q, k, v, pos), (q[3:], k[3:], v[3:], pos[3:])

    def paged(t, positions):
        q, k, v, table, pos = _paged_inputs(t, f32, f32, positions=positions)
        return (q, k, v, table, pos), (q[3:], k, v, table[3:], pos[3:])

    _check_slot_alone("decode_attention", dense, decode_attention_cuda,
                      decode_attention_splitk_cuda, ts)
    _check_slot_alone("paged_decode_attention", paged,
                      paged_decode_attention_cuda,
                      paged_decode_attention_splitk_cuda, ts)
    # each row of a T-row block (row tiles) bitwise the T = 1 launch at
    # pos + t, across the chunk boundaries at 256, 1024 and 4096
    for t in (t for t in ts if t > 1):
        for positions in ([-1, 1000, 4200, S - t], [253, 1021, 4093, S - t]):
            for window in WINDOWS_R:
                q, k, v, pos = _inputs(t, f32, f32, positions=positions)
                _rows_alone(f"decode_attention {tag} pos={positions} "
                            f"window={window}",
                            lambda qq, p, a: decode_attention_cuda(
                                qq, k, v, p, active=a, window=window),
                            q, pos)
                q, k, v, table, pos = _paged_inputs(t, f32, f32,
                                                    positions=positions)
                _rows_alone(f"paged_decode_attention {tag} pos={positions} "
                            f"window={window}",
                            lambda qq, p, a: paged_decode_attention_cuda(
                                qq, k, v, table, p, active=a,
                                window=window), q, pos)
            q, k, v, ks, vs, table, pos = _quant_paged_inputs(
                t, "int8", positions=positions)
            _rows_alone(f"paged_decode_attention {tag} int8 "
                        f"pos={positions}",
                        lambda qq, p, a: paged_decode_attention_cuda(
                            qq, k, v, table, p, active=a, k_scale=ks,
                            v_scale=vs), q, pos)
    torch.cuda.synchronize()
    return errs


def _row_many_row_checks():
    """#4 (256-row chunks at 0 and 3840, the ragged 104-row one at 4096;
    f32, bf16, int8 and fp8 pools) and #6 (S = 4096 causal, windows 0 and
    1024; S = 1000 with window 300, causal and not; a bf16 case) at the
    module's H and KV, whose G does not divide a CTA's rows: a CTA's
    flattened (position, head) rows start and end inside a position, and
    the last CTA's rows past the end must stay inert.  Returns the worst
    f32 (and quantized) error per kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (flash_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import \
        paged_prefill_attention_cuda

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    tag = f"H={H} KV={KV} G={H // KV} (flattened rows)"
    slot = B - 1
    for c, q_offset, window in ((CHUNK, 0, 0), (CHUNK, S // 2 - CHUNK, 0),
                                (CHUNK, S // 2 - CHUNK, 1024),
                                (RAGGED, S // 2, 0), (RAGGED, S // 2, 1024)):
        for kd in (f32, bf16):
            q, k, v, table, _ = _paged_inputs(1, f32, kd, chunk=c)
            p_round = None
            if kd == bf16:
                p_round = 2.0 ** -8 * paged_prefill_attention_plain(
                    q, k, v.abs(), table, slot, q_offset, window=window)
            err = _check(
                f"paged_prefill_attention {tag} C={c} q_offset={q_offset} "
                f"window={window} pool={kd}",
                paged_prefill_attention_cuda(q, k, v, table[slot], q_offset,
                                             window=window),
                paged_prefill_attention_plain(q, k, v, table, slot, q_offset,
                                              window=window), kd, p_round)
            if kd == f32:
                note("paged_prefill_attention", err)
        for name in QUANT:
            q, k, v, ks, vs, table, _ = _quant_paged_inputs(1, name, chunk=c)
            sc = dict(k_scale=ks, v_scale=vs, window=window)
            note(f"paged_prefill_attention_{name}", _check(
                f"paged_prefill_attention {tag} C={c} q_offset={q_offset} "
                f"window={window} pool={name}",
                paged_prefill_attention_cuda(q, k, v, table[slot], q_offset,
                                             **sc),
                paged_prefill_attention_plain(q, k, v, table, slot, q_offset,
                                              **sc), k.dtype))
    for s, causal, window, dt in ((FS, True, 0, f32), (FS, True, 1024, f32),
                                  (1000, True, 300, f32),
                                  (1000, False, 300, f32),
                                  (1000, True, 0, bf16)):
        q, k, v = _flash_inputs(FB, s, dt)
        p_round = None
        if dt == bf16:
            p_round = 2.0 ** -8 * flash_attention_plain(
                q, k, v.abs(), causal=causal, window=window)
        err = _check(
            f"flash_attention {tag} S={s} causal={causal} window={window} "
            f"{dt}", flash_attention_cuda(q, k, v, causal=causal,
                                          window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window), dt,
            p_round)
        if dt == f32:
            note("flash_attention", err)
        del q, k, v, p_round
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


def phase_row_kernels():
    """Phase 3r: the row tiles and the groupings of granite (G = 48) and
    qwen2.5 (G = 5), qwen3-moe's verify block and the G = 1 blocks past the
    8-row instance at head dims 80 and 64, against the plain versions;
    then each kernel on a model phase's
    path timed as in phase 3 (rows ``<kernel>_g48``, ``_g48_verify``,
    ``_g5``, ``_g5_verify``, ``_g16_verify``, ``_int8_g48``, ...,
    ``decode_attention_d64_t9``); the rest timed and printed."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ops import (decode_attention_plain,
                                         flash_attention_plain,
                                         paged_decode_attention_plain,
                                         paged_prefill_attention_plain)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)
    from repro_torch.models.attention import dequantize_kv

    dense_src = "src/repro_torch/kernels/csrc/decode_attention.cu"
    paged_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    dec_line = "src/repro/kernels/decode_attention.py"
    pag_line = "src/repro/kernels/paged_attention.py"
    f32 = torch.float32
    rows = []
    for label, h, kv, d, ts in ROW_CASES:
        with _heads(h, kv, d):
            errs = _row_decode_checks(ts)
            if label in ("g48", "g5"):
                errs.update(_row_many_row_checks())
            timed = []
            for t in ts:
                suffix = {1: "", VERIFY_T: "_verify"}.get(t, f"_t{t}")
                q, k, v, pos = _inputs(t, f32, f32)
                timed.append((
                    f"decode_attention_{label}{suffix}",
                    lambda q=q, k=k, v=v, pos=pos: decode_attention_cuda(
                        q, k, v, pos),
                    lambda q=q, k=k, v=v, pos=pos: decode_attention_plain(
                        q, k, v, pos),
                    _time_ms(_library_call(q, k, v, pos)),
                    _bound_ms(q, k, pos), dense_src, f"{dec_line}:131",
                    errs[("decode_attention", t)]))
                pq, pk, pv, table, ppos = _paged_inputs(t, f32, f32)
                timed.append((
                    f"paged_decode_attention_{label}{suffix}",
                    lambda a=(pq, pk, pv, table, ppos):
                        paged_decode_attention_cuda(*a),
                    lambda a=(pq, pk, pv, table, ppos):
                        paged_decode_attention_plain(*a),
                    _time_ms(_paged_library_call(pq, pk, pv, table, ppos)),
                    _bound_ms(pq, pk, ppos, paged=True), paged_src,
                    f"{pag_line}:131", errs[("paged_decode_attention", t)]))
            if 1 in ts:
                q, k, v, pos = _inputs(1, f32, f32)
                timed.append((
                    f"decode_attention_splitk_{label}",
                    lambda: decode_attention_splitk_cuda(q, k, v, pos,
                                                         num_splits=2),
                    lambda: decode_attention_plain(q, k, v, pos,
                                                   num_splits=2),
                    _time_ms(_library_call(q, k, v, pos)),
                    _bound_ms(q, k, pos), dense_src, f"{dec_line}:236",
                    errs[("decode_attention_splitk", 1)]))
                pq, pk, pv, table, ppos = _paged_inputs(1, f32, f32)
                timed.append((
                    f"paged_decode_attention_splitk_{label}",
                    lambda: paged_decode_attention_splitk_cuda(
                        pq, pk, pv, table, ppos, num_splits=2),
                    lambda: paged_decode_attention_plain(
                        pq, pk, pv, table, ppos, num_splits=2),
                    _time_ms(_paged_library_call(pq, pk, pv, table, ppos)),
                    _bound_ms(pq, pk, ppos, paged=True), paged_src,
                    f"{pag_line}:325",
                    errs[("paged_decode_attention_splitk", 1)]))
                iq, ik, iv, iks, ivs, itable, ipos = _quant_paged_inputs(
                    1, "int8")
                isc = dict(k_scale=iks, v_scale=ivs)
                lib_ms = _time_ms(_paged_library_call(
                    iq, dequantize_kv(ik, iks), dequantize_kv(iv, ivs),
                    itable, ipos))
                bound = _bound_ms(iq, ik, ipos, paged=True)
                timed += [
                    (f"paged_decode_attention_int8_{label}",
                     lambda: paged_decode_attention_cuda(
                         iq, ik, iv, itable, ipos, **isc),
                     lambda: paged_decode_attention_plain(
                         iq, ik, iv, itable, ipos, **isc),
                     lib_ms, bound, paged_src, f"{pag_line}:131",
                     errs[("paged_decode_attention_int8", 1)]),
                    (f"paged_decode_attention_splitk_int8_{label}",
                     lambda: paged_decode_attention_splitk_cuda(
                         iq, ik, iv, itable, ipos, num_splits=2, **isc),
                     lambda: paged_decode_attention_plain(
                         iq, ik, iv, itable, ipos, num_splits=2, **isc),
                     lib_ms, bound, paged_src, f"{pag_line}:325",
                     errs[("paged_decode_attention_splitk_int8", 1)])]
            if "paged_prefill_attention" in errs:
                slot, q_offset = B - 1, S // 2 - CHUNK
                cq, ck, cv, ctable, _ = _paged_inputs(1, f32, f32,
                                                      chunk=CHUNK)
                timed.append((
                    f"paged_prefill_attention_{label}",
                    lambda: paged_prefill_attention_cuda(
                        cq, ck, cv, ctable[slot], q_offset),
                    lambda: paged_prefill_attention_plain(
                        cq, ck, cv, ctable, slot, q_offset),
                    _time_ms(_prefill_library_call(cq, ck, cv, ctable[slot],
                                                   q_offset)),
                    _prefill_bound_ms(cq, ck, q_offset), paged_src,
                    f"{pag_line}:228", errs["paged_prefill_attention"]))
                jq, jk, jv, jks, jvs, jtable, _ = _quant_paged_inputs(
                    1, "int8", chunk=CHUNK)
                jsc = dict(k_scale=jks, v_scale=jvs)
                timed.append((
                    f"paged_prefill_attention_int8_{label}",
                    lambda: paged_prefill_attention_cuda(
                        jq, jk, jv, jtable[slot], q_offset, **jsc),
                    lambda: paged_prefill_attention_plain(
                        jq, jk, jv, jtable, slot, q_offset, **jsc),
                    _time_ms(_prefill_library_call(
                        jq, dequantize_kv(jk, jks), dequantize_kv(jv, jvs),
                        jtable[slot], q_offset)),
                    _prefill_bound_ms(jq, jk, q_offset), paged_src,
                    f"{pag_line}:228", errs["paged_prefill_attention_int8"]))
                fq, fk, fv = _flash_inputs(FB, FS, f32)
                qt = fq.transpose(1, 2)
                kx = fk.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                vx = fv.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                timed.append((
                    f"flash_attention_{label}",
                    lambda: flash_attention_cuda(fq, fk, fv),
                    lambda: flash_attention_plain(fq, fk, fv),
                    _time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kx, vx, is_causal=True)),
                    _flash_bound_ms(fq, fk, True, 0),
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:83",
                    errs["flash_attention"]))
            for name, run, plain, lib_ms, bound, src, replaces, err in timed:
                row = _timed_row(name, run, plain, lib_ms, bound, src,
                                 replaces, err)
                row["shape"] = f"H={h} KV={kv} D={d}"
                if name in ROW_ON_PATH:
                    rows.append(row)
                else:
                    _log(f"[kernels] {name}: checked and timed; not on a "
                         f"path this script drives")
            del timed
        _free_device()
    return rows


# ------------------------------------------------- 7 and 8: the new archs
@contextlib.contextmanager
def _count_windows():
    """Count the model's attention calls through ``ops`` by kernel and
    window: {(name, window): calls}.  Each call on the card is one launch
    of that kernel."""
    from repro_torch.kernels import ops

    names = ("decode_attention", "paged_decode_attention",
             "paged_prefill_attention", "flash_attention")
    fns = {n: getattr(ops, n) for n in names}
    counts = {}

    def counting(name):
        def call(*args, **kwargs):
            key = (name, kwargs.get("window", 0))
            counts[key] = counts.get(key, 0) + 1
            return fns[name](*args, **kwargs)
        return call

    for n in names:
        setattr(ops, n, counting(n))
    try:
        yield counts
    finally:
        for n, fn in fns.items():
            setattr(ops, n, fn)


def _check_windows(label, counts, model):
    """Every kernel the model called ran its local layers under the local
    window and its global layers under none, in the plan's proportion."""
    from repro_torch.models.transformer import _layers, build_plan

    plan = build_plan(model.cfg)
    per_tick = {}
    for layer in _layers(plan, model.cfg):
        per_tick[layer.window] = per_tick.get(layer.window, 0) + 1
    _log(f"[gemma3] {label}: calls by (kernel, window) {counts}; layers per "
         f"window {per_tick}")
    for name in {n for n, _ in counts}:
        got = {w: c for (n, w), c in counts.items() if n == name}
        if set(got) != set(per_tick) or any(
                got[w] * per_tick[0] != got[0] * per_tick[w] for w in got):
            raise AssertionError(f"{label}: {name} calls by window {got} "
                                 f"are not the plan's {per_tick}")


# 1 group of (5 local + 1 global) and the 2-layer rest (14 until phase 15
# came, cut for the run's time)
GEMMA_LAYERS = 8


def phase_gemma3():
    """Phase 7: gemma3-27b at full width, ``GEMMA_LAYERS`` of 62 layers."""
    model, params = make_model("gemma3-27b", GEMMA_LAYERS)
    label = "gemma3"
    with _count_windows() as counts:
        dense = phase_engine(model, params, f"{label} dense")
    _check_windows("dense continuous + wave", counts, model)
    with _count_windows() as counts:
        paged, f32_page_bytes = phase_paged_engine(model, params,
                                                   f"{label} paged")
    _check_windows("paged", counts, model)
    # int8 at many layers of width 5376: the kernel and plain routes round
    # more and more of their own K/V differently with depth, so the chunk
    # is held call by call (see _check_chunk_by_call)
    quant = phase_quant_engine(model, params, f32_page_bytes,
                               names=("int8",), label=f"{label} paged",
                               chunk_by_call=True)
    launches = dict(dense, **paged, **quant)
    # random gemma3 weights never repeat the prompts' patterns, so the
    # n-gram drafter would propose nothing: the plain streams are replayed
    launches["decode_attention_verify"] = _spec_pair(
        model, params, f"{label} dense", {}, replay=True)
    launches["paged_decode_attention_verify"] = _spec_pair(
        model, params, f"{label} paged", dict(cache="paged", page_size=PAGE),
        replay=True)
    _preemption_checks(model, params, layouts=("dense",))
    with _count_windows() as counts:
        launches["flash_attention"], _ = phase_forward_attention(model,
                                                                 params)
    _check_windows("prefill step", counts, model)
    del model, params
    _free_device()
    _log(f"[gemma3] launches: {launches}")
    return launches


MIXTRAL_LAYERS, QWEN_LAYERS = 4, 2


def phase_moe():
    """Phase 8: mixtral-8x7b (4 of 32 layers) and qwen3-moe-235b-a22b (2 of
    94) at full width.  Returns the launches keyed as phase 3g's rows (and
    3r's, for qwen3-moe's verify block)."""
    launches = {}
    model, params = make_model("mixtral-8x7b", MIXTRAL_LAYERS)
    g = model.cfg.num_heads // model.cfg.num_kv_heads
    dense = phase_engine(model, params, "mixtral dense")
    paged, _ = phase_paged_engine(model, params, "mixtral paged")
    launches.update({f"{n.removesuffix('_cuda')}_g{g}": c
                     for n, c in dense.items()})
    launches.update({f"{n}_g{g}": c for n, c in paged.items()})
    launches[f"decode_attention_g{g}_verify"] = _spec_pair(
        model, params, "mixtral dense", {}, replay=True)
    launches[f"paged_decode_attention_g{g}_verify"] = _spec_pair(
        model, params, "mixtral paged", dict(cache="paged", page_size=PAGE),
        replay=True)
    launches[f"flash_attention_g{g}"], _ = phase_forward_attention(
        model, params, 1, FS)
    del model, params
    _free_device()

    model, params = make_model("qwen3-moe-235b-a22b", QWEN_LAYERS)
    g = model.cfg.num_heads // model.cfg.num_kv_heads
    launches[f"flash_attention_g{g}"], _ = phase_forward_attention(
        model, params, 1, 2048)
    dense = phase_engine(model, params, "qwen3-moe dense")
    paged, _ = phase_paged_engine(model, params, "qwen3-moe paged")
    launches.update({f"{n.removesuffix('_cuda')}_g{g}": c
                     for n, c in dense.items()})
    launches.update({f"{n}_g{g}": c for n, c in paged.items()})
    # G * T = 16 * 4 = 64 query rows per KV head: the row tiles (phase 3r)
    launches[f"decode_attention_g{g}_verify"] = _spec_pair(
        model, params, "qwen3-moe dense", {}, replay=True)
    launches[f"paged_decode_attention_g{g}_verify"] = _spec_pair(
        model, params, "qwen3-moe paged", dict(cache="paged", page_size=PAGE),
        replay=True)
    del model, params
    _free_device()
    _log(f"[moe] launches: {launches}")
    return launches


# ------------------------------------------------------ 9: zamba2-2.7b
ZB, ZS = 2, 4096  # zamba2's prefill step: 2 prompts x 4096 tokens
ZAMBA2_LAYERS = 18  # of 54: 3 of its 9 groups (the run's time limit)


def _place(dst, src):
    """Copy a cache tree ``src`` into ``dst`` of the same tree, in place:
    leaves of one shape whole, K/V stripes (..., B, S, KV, D) of a shorter
    ``src`` into the first positions of ``dst``'s."""
    if isinstance(dst, dict):
        for k in dst:
            _place(dst[k], src[k])
        return dst
    if dst.shape == src.shape:
        dst.copy_(src)
    else:
        dst.narrow(-3, 0, src.shape[-3]).copy_(src)
    return dst


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _zamba2_decode(model, params, caches, first):
    """Decode from the prefill's caches placed in an ``init_cache(ZB, S)``
    stripe at position ZS: one step with splits 1 (#1 at D = 80) and 2
    (#2), bitwise equal (ZS is whole chunks), the logits against the
    plain path; then 8 greedy steps at splits 2."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.runtime.steps import compiled_step

    dec = _place(model.init_cache(ZB, S), caches)
    pos = np.full(ZB, ZS, np.int32)
    logits = {}
    for splits, kern in ((1, decode_attention_cuda),
                         (2, decode_attention_splitk_cuda)):
        step = compiled_step(model, "decode_one", decode_splits=splits)
        before = kern.launches
        logits[splits], _ = step(params, _clone(dec), first, pos)
        n = kern.launches - before
        _log(f"[zamba2] decode step at pos {ZS}, splits={splits}: "
             f"{kern.__name__} launched {n} times")
        if n != model.cfg.num_layers // model.cfg.shared_attn_period:
            raise AssertionError("the shared block's decode did not launch "
                                 "its kernel once per group")
    same = torch.equal(logits[1], logits[2])
    _log(f"[zamba2] decode logits, splits=2 equal splits=1 bitwise: {same}")
    if not same:
        raise AssertionError("zamba2's split-K decode differs from the "
                             "single pass")
    with _plain_attention():
        want, _ = compiled_step(model, "decode_one", decode_splits=1)(
            params, _clone(dec), first, pos)
    _check_logits(f"zamba2 decode logits at pos {ZS}, kernels vs plain",
                  logits[1], want)
    serve = compiled_step(model, "serve", decode_splits=2)
    nxt, out = first, [first]
    for i in range(8):
        nxt, dec = serve(params, dec, nxt, pos + i)
        out.append(nxt)
    stream = torch.cat(out, 1)
    if not bool(((stream >= 0) & (stream < model.cfg.vocab_size)).all()):
        raise AssertionError("decode tokens outside the vocabulary")
    _log(f"[zamba2] 8 decode steps after the prefill (splits=2): "
         f"{stream.tolist()}")
    del dec


def _zamba2_token_feed(model, params, prompt, n_new=8):
    """One 128-token prompt: prefill then decode against the token feed the
    engine runs (decode steps from a zeroed slot), and the engine's tokens
    against prefill-then-decode."""
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    n = prompt.shape[1]
    lp, pc = model.prefill(params, {"tokens": prompt})
    pc = _place(model.init_cache(1, 256), pc)
    fed = model.init_cache(1, 256)
    for t in range(n):
        lf, fed = model.decode_step(params, fed, prompt[:, t:t + 1], t)
    errs = [_check_logits(f"zamba2 {n}-token prompt: prefill vs token feed",
                          lp, lf, SSM_FEED_TOL)]
    pref = [int(lp.argmax())]
    for i in range(n_new - 1):
        tok = torch.tensor([[pref[-1]]], device="cuda")
        lp, pc = model.decode_step(params, pc, tok, n + i)
        lf, fed = model.decode_step(params, fed, tok, n + i)
        errs.append(float((lp - lf).abs().max()))
        pref.append(int(lp.argmax()))
    _log(f"[zamba2] prefill-then-decode vs token-fed logits over {n_new} "
         f"steps: max_abs_err {max(errs):.3g} (tol {SSM_FEED_TOL})")
    if max(errs) > SSM_FEED_TOL:
        raise AssertionError("prefill-then-decode and token-fed logits "
                             "disagree")
    eng = ServeEngine(model, params, ServeConfig(batch_slots=B, max_len=256))
    h = eng.submit(Request(0, prompt[0].cpu().numpy().astype(np.int32),
                           max_new_tokens=n_new))
    eng.run()
    _log(f"[zamba2] engine (token-fed) tokens {h.req.output}; prefill-then-"
         f"decode {pref}")
    if h.req.output != pref:
        raise AssertionError("the engine's tokens differ from "
                             "prefill-then-decode")


def _zamba2_engines(model, params):
    """Continuous serving of more requests than slots (prompts <= 128
    tokens), a reused slot against a fresh engine, wave mode with the
    same streams, and one preemption."""
    from repro_torch.runtime.serve import Request, ServeConfig, ServeEngine

    rng = np.random.default_rng(8)
    vocab = model.cfg.vocab_size
    reqs = [(i, rng.integers(0, vocab, size=n).astype(np.int32))
            for i, n in enumerate((20, 7, 128, 12, 45, 9))]
    config = dict(batch_slots=B, max_len=256)
    eng = ServeEngine(model, params, ServeConfig(**config))
    handles = [eng.submit(Request(i, p, max_new_tokens=16)) for i, p in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    _log(f"[zamba2] engine continuous: {len(done)}/6 requests, {toks} "
         f"tokens in {wall:.3f}s = {toks / wall:.2f} tok/s (prompts fed "
         f"token by token, a tick each)")
    if len(done) != 6 or any(len(r.output) != 16 for r in done) or any(
            not 0 <= t < vocab for r in done for t in r.output):
        raise AssertionError("zamba2 continuous run did not finish")
    solo = ServeEngine(model, params, ServeConfig(**config))
    hs = solo.submit(Request(5, reqs[5][1], max_new_tokens=16))
    solo.run()
    _log(f"[zamba2] reused slot vs fresh engine: {handles[5].req.output} vs "
         f"{hs.req.output}")
    if hs.req.output != handles[5].req.output:
        raise AssertionError("a reused slot's tokens differ from a fresh "
                             "engine's")
    del solo
    wave = ServeEngine(model, params, ServeConfig(mode="wave", **config))
    for i, p in reqs:
        wave.submit(Request(i, p, max_new_tokens=16))
    wdone = {r.req_id: list(r.output) for r in wave.run()}
    same = wdone == {r.req_id: list(r.output) for r in done}
    _log(f"[zamba2] engine wave: {len(wdone)}/6 requests; streams equal to "
         f"continuous: {same}")
    if len(wdone) != 6:
        raise AssertionError("zamba2 wave run did not finish")
    del eng, wave
    _free_device()
    _preemption_checks(model, params, layouts=("dense",),
                       lens=((40, 33, 57, 29), (9, 14)), max_len=256)


def _zamba2_tick(model, params):
    """A decode tick of 4 slots at pos [4300, 300, -1, 4200] in an
    8192-position cache (the shared block's K/V for 3 groups: 2.0 GB),
    single pass against split-K 2, timed over rounds and profiled."""
    from repro_torch.runtime.steps import compiled_step

    caches = model.init_cache(B, S)
    toks_in = torch.tensor([[5], [6], [7], [8]], device="cuda")
    pos = np.array([4300, 300, -1, 4200], np.int32)
    ticks = {s: functools.partial(
        compiled_step(model, "serve", decode_splits=s), params, caches,
        toks_in, pos) for s in (1, 2)}
    ms = _time_ms(ticks[1], iters=10, warmup=2, queued=False)
    _log(f"[zamba2] decode tick: {ms:.3f} ms for 3 live slots = "
         f"{3e3 / ms:.1f} tok/s")
    _time_ticks(ticks, f"zamba2 decode tick at pos {pos.tolist()}")
    del caches, ticks


def phase_zamba2():
    """Phase 9: zamba2-2.7b at full width, ``ZAMBA2_LAYERS`` of 54 layers.
    Returns the launches of the phase, keyed as the rows of phases 3h and
    3c."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_splitk_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    from repro_torch.runtime.steps import make_prefill_step

    model, params = make_model("zamba2-2.7b", ZAMBA2_LAYERS)
    cfg = model.cfg
    groups = cfg.num_layers // cfg.shared_attn_period
    kernels = (flash_attention_cuda, ssd_chunk_cuda, decode_attention_cuda,
               decode_attention_splitk_cuda)
    for kern in kernels:
        kern.launches = 0
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(ZB, ZS)),
                           device="cuda")
    batch = {"tokens": toks}
    step = make_prefill_step(model)
    first, caches = step(params, batch)
    torch.cuda.synchronize()
    n_flash, n_ssd = flash_attention_cuda.launches, ssd_chunk_cuda.launches
    outer = caches["groups"]["outer"]
    _log(f"[zamba2] prefill step {ZB} x {ZS}: ssd_chunk launches {n_ssd}, "
         f"flash_attention launches {n_flash}; shared-block K/V "
         f"{tuple(outer['k'].shape)}; state "
         f"{tuple(caches['groups']['inner']['state'].shape)}")
    if (n_ssd, n_flash) != (cfg.num_layers, groups):
        raise AssertionError(f"zamba2's prefill launched #7 {n_ssd} and #6 "
                             f"{n_flash} times, not {cfg.num_layers} and "
                             f"{groups}")
    if not bool(((first >= 0) & (first < cfg.vocab_size)).all()):
        raise AssertionError("prefill tokens outside the vocabulary")
    logits, _ = model.prefill(params, batch)
    with _plain_attention():
        want, _ = model.prefill(params, batch)
    _check_logits("zamba2 prefill logits, kernels vs plain", logits, want)
    del logits, want
    _zamba2_decode(model, params, caches, first)
    del caches
    _zamba2_token_feed(model, params, toks[:1, :128])
    _zamba2_engines(model, params)
    # the path's launches: the prefill, the decode, the token feed and the
    # engines (not the timing below)
    launches = {"flash_attention_d80": flash_attention_cuda.launches,
                "ssd_chunk_zamba2": ssd_chunk_cuda.launches,
                "decode_attention_d80": decode_attention_cuda.launches,
                "decode_attention_splitk_d80":
                    decode_attention_splitk_cuda.launches}
    _zamba2_tick(model, params)
    times = _timed_prefill(functools.partial(step, params, batch),
                           f"zamba2 prefill step {ZB} x {ZS}")
    _profile_tick(functools.partial(step, params, batch),
                  f"zamba2 prefill step {ZB} x {ZS}", ticks=1, top=10)
    del model, params, step, batch
    _free_device()
    _log(f"[zamba2] launches: {launches}; prefill {times}")
    return launches


# ---------------------------------------------------- 10: musicgen-large
MUSICGEN_LAYERS = 12  # of 48


def phase_musicgen():
    """Phase 10: musicgen-large at full width, 12 of 48 layers: phases 4
    and 4b, an int8 paged run, a 1 x 4096 prefill step, and speculative
    decode at draft_k = 8 on the dense cache (T = 9 rows a slot at G = 1:
    two row tiles of the 8-row instance).  Returns the launches keyed as
    phase 3h's D = 64 rows (and 3r's ``decode_attention_d64_t9``)."""
    model, params = make_model("musicgen-large", MUSICGEN_LAYERS)
    label = "musicgen"
    verify = _spec_pair(model, params, f"{label} dense", {}, replay=True,
                        draft_k=MUSICGEN_DRAFT_K)
    launches = dict(phase_engine(model, params, f"{label} dense"))
    paged, f32_page_bytes = phase_paged_engine(model, params,
                                               f"{label} paged")
    launches.update(paged)
    launches.update(phase_quant_engine(model, params, f32_page_bytes,
                                       names=("int8",),
                                       label=f"{label} paged",
                                       chunk_by_call=True))
    launches["flash_attention"], _ = phase_forward_attention(model, params,
                                                             1, FS)
    del model, params
    _free_device()
    launches = {f"{n}_d64": c for n, c in launches.items()}
    launches[f"decode_attention_d64_t{MUSICGEN_DRAFT_K + 1}"] = verify
    _log(f"[musicgen] launches: {launches}")
    return launches


# --------------------------------------- 11 and 12: granite, qwen2.5
# Depth cut so that one card holds the f32 weights: granite-20b 1.516 GB a
# layer (25.5 GB at 16 layers with the tied embedding), qwen2.5-32b 1.950
# GB a layer (29.6 GB at 12 with its untied embedding and unembedding).
# Cut further (16 and 12 before phase 15 came) for the run's time.
GRANITE_LAYERS = 8  # of 52
QWEN25_LAYERS = 6  # of 64


def _phase_grouped(arch, num_layers, label):
    """Phases 11 and 12: ``arch`` at full width and ``num_layers``: phase
    4's dense serving (split-K engages), logits, tick and wave trace; phase
    4b's paged trace with the prefix hit and the replay; an int8 paged run;
    the speculative pair (draft_k = 3, replayed streams), dense and paged,
    bitwise the plain engine; one preemption on the dense cache; the 2 x
    4096 prefill step through #6.  Returns the launches keyed as phase
    3r's rows (``<kernel>_g<G>``, ``<kernel>_g<G>_verify``)."""
    model, params = make_model(arch, num_layers)
    g = model.cfg.num_heads // model.cfg.num_kv_heads
    launches = dict(phase_engine(model, params, f"{label} dense"))
    paged, f32_page_bytes = phase_paged_engine(model, params,
                                               f"{label} paged")
    launches.update(paged)
    launches.update(phase_quant_engine(model, params, f32_page_bytes,
                                       names=("int8",),
                                       label=f"{label} paged",
                                       chunk_by_call=True))
    # random weights never repeat the prompts' patterns: replay the plain
    # streams so that verify ticks accept drafts
    verify = {"decode_attention": _spec_pair(
        model, params, f"{label} dense", {}, replay=True),
        "paged_decode_attention": _spec_pair(
            model, params, f"{label} paged",
            dict(cache="paged", page_size=PAGE), replay=True)}
    _preemption_checks(model, params, layouts=("dense",))
    launches["flash_attention"], _ = phase_forward_attention(model, params)
    del model, params
    _free_device()
    launches = {f"{n}_g{g}": c for n, c in launches.items()}
    launches.update({f"{n}_g{g}_verify": c for n, c in verify.items()})
    _log(f"[{label}] launches: {launches}")
    return launches


# ------------------------------------------- 13: llava-next-mistral-7b
# 16 of 32 layers (full depth, 28.97 GB of f32 weights, until phase 15
# came: cut for the run's time)
LLAVA_LAYERS = 16


def _embeddings_prefill(model, params, fs=FS):
    """llava's whole-prompt prefill (1 x ``fs``) on the embeddings route,
    ``batch["embeds"] = params["embed"]["table"][tokens]``: one flash
    attention launch per layer; the logits equal the token route's (the
    same weights in a model that embeds the token ids itself, as the
    engines do) bitwise, since the lookup is exact; against the plain path
    within LOGIT_TOL; timed and profiled.  Returns the launches."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = model.cfg
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, fs)),
                           device="cuda")
    batch = {"tokens": toks, "embeds": params["embed"]["table"][toks]}
    flash_attention_cuda.launches = 0
    got, caches = model.prefill(params, batch)
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    del caches
    by_tokens = type(model)(dataclasses.replace(cfg, input_mode="tokens"),
                            model.knobs, model.device)
    want, caches = by_tokens.prefill(params, {"tokens": toks})
    del caches
    same = torch.equal(got, want)
    _log(f"[llava] prefill 1 x {fs} from embeddings: flash_attention "
         f"launches {launches}; logits equal the token route's bitwise: "
         f"{same}")
    if launches != cfg.num_layers or not same:
        raise AssertionError("llava's embeddings prefill: a launch per "
                             "layer and the token route's logits expected")
    with _plain_attention():
        plain, _ = model.prefill(params, batch)
    _check_logits(f"{cfg.name} prefill logits, kernel vs plain", got, plain)
    del plain
    run = functools.partial(model.prefill, params, batch)
    _timed_prefill(run, f"{cfg.name} prefill 1 x {fs} (embeddings)")
    _profile_tick(run, f"{cfg.name} prefill 1 x {fs}", ticks=1, top=8)
    return launches


def phase_llava():
    """Phase 13: llava-next-mistral-7b's backbone at full width,
    ``LLAVA_LAYERS`` of 32 layers, alone on the card: the embeddings prefill, then phase 4's dense
    serving (logits, tick, wave trace) and phase 4b's paged trace with the
    prefix hit.  Returns the launches keyed as phase 3g's G = 4 rows."""
    model, params = make_model("llava-next-mistral-7b", LLAVA_LAYERS)
    g = model.cfg.num_heads // model.cfg.num_kv_heads
    launches = {"flash_attention": _embeddings_prefill(model, params)}
    launches.update(phase_engine(model, params, "llava dense"))
    paged, _ = phase_paged_engine(model, params, "llava paged")
    launches.update(paged)
    del model, params
    _free_device()
    launches = {f"{n}_g{g}": c for n, c in launches.items()}
    _log(f"[llava] launches: {launches}")
    return launches


# ------------------------------------------------- 14: the serving cluster
# internlm2-1.8b at full width, CLUSTER_LAYERS of 24 layers (the run's time
# limit): replicas of 4 slots, 2048 positions, 256-token prefill chunks;
# 16-token pages
CLUSTER_LAYERS = 8
CLUSTER = dict(batch_slots=4, max_len=2048, prefill_chunk=256)
# the prefix cache off, so that every pool drains to zero held pages
CLUSTER_PAGED = dict(CLUSTER, cache="paged", page_size=PAGE,
                     prefix_cache=False)
CLUSTER_REQUESTS = 12
# (a): replica 1 killed mid-decode and rejoined, replica 2's heartbeats
# dropped past the miss threshold (2) and rejoined, replica 0 stalled.
# The injector's stall sleeps before the router's watchdog starts its
# clock (``ReplicaHandle.step``, a fault of the reference that the copy
# keeps), so replica 0 also straggles inside its engine's step at those
# ticks, where the watchdog times it
CHAOS = "6:kill:1,14:rejoin:1,18:hbdrop:2:0:3,26:rejoin:2,30:stall:0:0.6:2"
STRAGGLE_TICKS = (30, 31)
MISS_THRESHOLD = 2
# (d): arrivals per router tick, a burst, an idle stretch and a burst
BURSTS = {1: 6, 2: 6, 3: 4, 100: 3, 101: 3}


def _cluster_requests(vocab, n=CLUSTER_REQUESTS, seed=14):
    """Prompts of 200-900 tokens, 24-48 new tokens each; odd requests
    seeded-sampled (temperature 0.8, top-p 0.9), even ones greedy."""
    from repro_torch.runtime.serve import Request, SamplingParams

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(200, 901)))
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=7) if i % 2
              else SamplingParams())
        out.append(Request(i, prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(24, 49)),
                           sampling=sp,
                           tenant="gold" if i % 3 == 0 else "free"))
    return out


def _fresh(reqs):
    return [dataclasses.replace(r, prompt=np.asarray(r.prompt).copy(),
                                output=[]) for r in reqs]


def _streams(done):
    return {r.req_id: list(r.output) for r in done}


class _Launches:
    """The engine kernels' launches over the runs inside ``with``, added
    to ``totals`` (the rows of phases 3 and 3p; ``suffix`` "_int8": phase
    3q's)."""

    def __init__(self, totals, suffix=""):
        self.totals = totals
        self.suffix = suffix

    def __enter__(self):
        for kern in _all_kernels():
            kern.launches = 0

    def __exit__(self, *exc):
        for kern in _all_kernels():
            name = kern.__name__.removesuffix("_cuda") + self.suffix
            self.totals[name] = self.totals.get(name, 0) + kern.launches


def _first_difference(model, params, reqs, got, want, label):
    """Raise on the first request whose stream differs from ``want``,
    printing the position and the top-2 margin of the logits there (the
    whole-sequence prefill of the prompt and the agreed tokens)."""
    for r in reqs:
        a, b = got.get(r.req_id), want[r.req_id]
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a or [], b)) if x != y),
                 min(len(a or []), len(b)))
        toks = np.concatenate([r.prompt, np.asarray(b[:k], np.int32)])
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
            toks[None], device=model.device)})
        top = torch.topk(logits[0], 2).values
        _log(f"[cluster] {label}: request {r.req_id} differs first at "
             f"output position {k} ({(a or [])[k:k + 1]} against "
             f"{b[k:k + 1]}); top-2 logit margin there "
             f"{float(top[0] - top[1]):.3g}")
        raise AssertionError(f"{label}: streams differ from the twin run")


def _balanced(router, label):
    for rh in router.replicas:
        if rh.engine is not None and rh.engine.kv is not None:
            pool = rh.engine.kv.pool
            if pool.in_use or np.any(np.asarray(pool.ref[1:])):
                raise AssertionError(f"{label}: replica {rh.rid} holds "
                                     f"{pool.in_use} pages after the run")


def _tickets_zero(label):
    from repro_torch.kernels import decode_attention

    held = {str(k): int(t.count_nonzero())
            for k, t in decode_attention._TICKETS.items()}
    if any(held.values()):
        raise AssertionError(f"{label}: ticket counters left in use {held}")


def _run_router(router, reqs, label, vocab, on_tick=None):
    """``reqs`` through ``router`` to the end; every request must finish
    at its length with tokens in ``range(vocab)``, none failed."""
    t0 = time.perf_counter()
    for r in _fresh(reqs):
        router.submit(r)
    ticks = 0
    while sum(router._pending_counts()):
        router.step()
        ticks += 1
        if on_tick is not None:
            on_tick(router)
        if ticks > 2000:
            raise AssertionError(f"{label}: the router stalled")
    done = router.run(max_ticks=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = router.stats()
    toks = sum(len(r.output) for r in done)
    replicas = {k: (v["state"], v["placements"], v["flags"])
                for k, v in st["replicas"].items()}
    _log(f"[cluster] {label}: {len(done)}/{len(reqs)} requests, {toks} "
         f"tokens in {ticks} router ticks, {wall:.3f}s; lost "
         f"{st['replicas_lost']} recoveries {st['recoveries']} failed "
         f"{st['failed']} brownout {st['brownout_ticks']}; replicas "
         f"(state, placements, flags) {replicas}")
    want = {r.req_id: r.max_new_tokens for r in reqs}
    if {r.req_id: len(r.output) for r in done} != want or st["failed"]:
        raise AssertionError(f"{label}: a request did not finish")
    if any(not 0 <= t < vocab for r in done for t in r.output):
        raise AssertionError(f"{label}: token outside the vocabulary")
    return _streams(done), st


def _cluster_chaos(model, params, totals):
    """(a) ``ClusterRouter`` over 3 paged f32 replicas, spread and pack:
    a fault-free run, then the same requests under ``CHAOS``; every stream
    equals the first fault-free run's, every pool drains, and the card's
    memory after replica 1's rejoin is within one pool of its value before
    the kill."""
    from repro_torch.runtime.cluster import ClusterRouter
    from repro_torch.runtime.fault import ReplicaFaultInjector
    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    config = ServeConfig(**CLUSTER_PAGED)
    reqs = _cluster_requests(model.cfg.vocab_size)
    routers = []

    class Straggler(ServeEngine):
        def step(self):
            if (self.replica == 0
                    and routers[-1].tick_count in STRAGGLE_TICKS):
                time.sleep(0.6)
            return super().step()

    want = None
    for policy in ("spread", "pack"):
        router = ClusterRouter(lambda rid: ServeEngine(model, params, config),
                               3, policy=policy)
        with _Launches(totals):
            got, _ = _run_router(router, reqs, f"{policy} fault-free",
                                 model.cfg.vocab_size)
        if want is None:
            want = got
        _first_difference(model, params, reqs, got, want,
                          f"{policy} fault-free")
        _balanced(router, f"{policy} fault-free")
        pool_bytes = router.replicas[1].engine.kv_reserved_bytes()
        del router
        _free_device()
        mem = {}

        def watch(router):
            t = router.tick_count
            if t == 5:  # the tick before the kill
                mem["before"] = torch.cuda.memory_allocated()
            rh = router.replicas[1]
            if "after" not in mem and t > 6 and rh.engine is not None:
                mem["after"] = torch.cuda.memory_allocated()

        router = ClusterRouter(
            lambda rid: Straggler(model, params, config), 3, policy=policy,
            miss_threshold=MISS_THRESHOLD,
            injector=ReplicaFaultInjector.parse(CHAOS))
        routers.append(router)
        with _Launches(totals):
            got, st = _run_router(router, reqs, f"{policy} chaos {CHAOS}",
                                  model.cfg.vocab_size, on_tick=watch)
        grow = mem["after"] - mem["before"]
        _log(f"[cluster] {policy} chaos: memory_allocated before the kill "
             f"{mem['before']} B, after the rejoin {mem['after']} B "
             f"({grow:+d} B; a pool is {pool_bytes} B)")
        flags = [f[0] for f in router.replicas[0].watchdog.flagged]
        _log(f"[cluster] {policy} chaos: replica 0's watchdog flagged "
             f"ticks {flags} (the straggle at {STRAGGLE_TICKS})")
        if (st["replicas_lost"] != 2 or st["recoveries"] < 2
                or not set(flags) & set(STRAGGLE_TICKS)
                or abs(grow) >= pool_bytes):
            raise AssertionError(f"{policy} chaos: two replicas lost, "
                                 f"replays, the straggle flagged and the "
                                 f"fenced pool freed expected: {st}, grow "
                                 f"{grow}")
        routers.clear()
        _first_difference(model, params, reqs, got, want, f"{policy} chaos")
        _log(f"[cluster] {policy} chaos: streams equal the fault-free "
             f"run's, token for token")
        _balanced(router, f"{policy} chaos")
        del router
        _free_device()
    _tickets_zero("(a)")
    return want


def _timed_copies(model, log):
    """Wrap ``model.copy_cache_pages_across`` to time each call with CUDA
    events and append (pages, bytes read + written, ms) to ``log``."""
    from repro_torch.models.transformer import tree_leaves

    copy = model.copy_cache_pages_across

    def timed(src, dst, src_idx, dst_idx):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = copy(src, dst, src_idx, dst_idx)
        end.record()
        end.synchronize()
        n = int(src_idx.numel())
        moved = 2 * n * sum(t[..., 0, :, :, :].numel() * t.element_size()
                            for t in tree_leaves(dst))
        log.append((n, moved, start.elapsed_time(end)))
        return out

    model.copy_cache_pages_across = timed


def _unified(model, params, config, reqs, totals, label, suffix=""):
    from repro_torch.runtime.serve import ServeEngine

    eng = ServeEngine(model, params, config)
    with _Launches(totals, suffix):
        for r in _fresh(reqs):
            eng.submit(r)
        done = eng.run()
    _log(f"[cluster] {label} unified engine: {len(done)} requests")
    del eng
    return _streams(done)


def _disagg_paged(model, params, totals, smi):
    """(b) ``DisaggRouter`` prefill=1, decode=2 on f32 pools, then int8:
    streams bitwise one unified engine's with the same slots; the
    prefill replica killed mid-handoff once and rejoined, streams still
    equal; both pools drain; each page transfer timed."""
    from repro_torch.runtime.disagg import DisaggRouter
    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    roles = ["prefill", "decode", "decode"]
    reqs = _cluster_requests(model.cfg.vocab_size, seed=15)
    for kv_dtype in ("", "int8"):
        name = kv_dtype or "f32"
        suffix = f"_{kv_dtype}" if kv_dtype else ""
        config = ServeConfig(**CLUSTER_PAGED, kv_dtype=kv_dtype)
        want = _unified(model, params, config, reqs, totals, name, suffix)
        # the kill mid-handoff once, on the f32 pools
        for kill in (False, True) if not kv_dtype else (False,):
            # the replicas' model (the pools' knobs set, so no engine
            # rebuilds it), its page transfers timed
            copies = []
            xmodel = type(model)(model.cfg, model.knobs.with_(
                kv_quant=kv_dtype), model.device)
            _timed_copies(xmodel, copies)
            router = DisaggRouter(lambda rid: ServeEngine(
                xmodel, params, dataclasses.replace(config, role=roles[rid])),
                3, roles=roles, miss_threshold=1)
            state = {"killed": None}

            def kill_mid_handoff(router):
                if (kill and state["killed"] is None
                        and any(h.src == 0 and h.n_pages
                                for h in router.handoffs)):
                    state["killed"] = router.tick_count
                    router.replicas[0].killed = True
                elif (state["killed"] is not None
                      and router.replicas[0].engine is None
                      and router.tick_count >= state["killed"] + 3):
                    router.rejoin(0)

            label = f"disagg {name}{' kill mid-handoff' if kill else ''}"
            with _Launches(totals, suffix):
                got, st = _run_router(router, reqs, label,
                                      model.cfg.vocab_size,
                                      on_tick=kill_mid_handoff)
            _log(f"[cluster] {label}: handoffs {st['handoffs_done']}, "
                 f"backpressure {st['handoff_backpressure']}")
            if kill and (state["killed"] is None or st["recoveries"] < 1):
                raise AssertionError(f"{label}: no kill mid-handoff")
            _first_difference(model, params, reqs, got, want, label)
            _log(f"[cluster] {label}: streams equal the unified engine's "
                 f"bitwise")
            _balanced(router, label)
            if copies:
                pages = sum(c[0] for c in copies)
                moved = sum(c[1] for c in copies)
                ms = sum(c[2] for c in copies)
                rate = moved / (ms * 1e-3)
                each = ", ".join(f"{n}p/{t:.3f}ms" for n, _, t in copies)
                _log(f"[cluster] {label}: {len(copies)} page transfers, "
                     f"{pages} pages, {moved} B read + written, "
                     f"{ms:.3f} ms in all ({rate / 1e12:.3f} TB/s, "
                     f"{rate / 3.35e12:.3f} of 3.35 TB/s; each "
                     f"transfer {each}); {smi}")
            del router, xmodel
            _free_device()
    _tickets_zero("(b)")


def _disagg_dense(model, params, totals):
    """(c) The dense pair (prefill=1, decode=1): host snapshots, streams
    bitwise one unified engine's; each snapshot's bytes and copy ms."""
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.disagg import DisaggRouter
    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    roles = ["prefill", "decode"]
    config = ServeConfig(**CLUSTER)
    reqs = _cluster_requests(model.cfg.vocab_size, n=6, seed=16)
    want = _unified(model, params, config, reqs, totals, "dense")
    copies = []
    model_copy = type(model)(model.cfg, model.knobs, model.device)
    for attr in ("copy_cache_out", "copy_cache_in"):
        fn = getattr(model_copy, attr)

        def timed(*a, _fn=fn, _attr=attr, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            snap = out if _attr == "copy_cache_out" else a[1]
            copies.append((_attr, sum(t.numel() * t.element_size()
                                      for t in tree_leaves(snap)),
                           (time.perf_counter() - t0) * 1e3))
            return out

        setattr(model_copy, attr, timed)
    router = DisaggRouter(lambda rid: ServeEngine(
        model_copy, params, dataclasses.replace(config, role=roles[rid])),
        2, roles=roles)
    with _Launches(totals):
        got, st = _run_router(router, reqs, "disagg dense",
                              model.cfg.vocab_size)
    _first_difference(model, params, reqs, got, want, "disagg dense")
    outs = [c for c in copies if c[0] == "copy_cache_out"]
    ins = [c for c in copies if c[0] == "copy_cache_in"]
    _log(f"[cluster] disagg dense: streams equal the unified engine's "
         f"bitwise; {st['handoffs_done']} handoffs; snapshots "
         f"{outs[0][1] if outs else 0} B each; to the host "
         f"{', '.join(f'{c[2]:.1f}' for c in outs)} ms; back "
         f"{', '.join(f'{c[2]:.1f}' for c in ins)} ms (host clock, "
         f"synchronized)")
    if len(outs) != len(reqs) or len(ins) != len(reqs):
        raise AssertionError("disagg dense: a snapshot per request expected")
    del router, model_copy
    _free_device()


def _autoscaled(model, params, totals):
    """(d) ``Autoscaler`` (queue-depth) on a ``DisaggRouter`` (prefill 1
    of up to 2, decode 1 of up to 4) under ``BURSTS``: decode scales up
    and then down, a retiring decode replica drains through ``release()``
    (its running requests handed off to a sibling), every stream equals
    the unified engine's, every pool ends balanced.  The queue-depth
    policy shrinks a role only at two replicas' worth of free slots and
    retires the idlest replica, which may hold nothing: if no retiree
    held a request by the second burst, the adapter's own scale-down
    (``begin_scale_down``) is called once at a tick where every decode
    replica holds one, and the log says so."""
    from repro_torch.runtime.autoscale import Autoscaler
    from repro_torch.runtime.disagg import DisaggRouter
    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    roles = ["prefill", "prefill"] + ["decode"] * 4
    config = ServeConfig(**CLUSTER_PAGED)
    n = sum(BURSTS.values())
    reqs = _cluster_requests(model.cfg.vocab_size, n=n, seed=17)
    want = _unified(model, params, config, reqs, totals, "autoscale")
    releases = []

    class Counted(ServeEngine):
        def release(self, req):
            releases.append((router.tick_count, self.role, req.req_id))
            return super().release(req)

    router = DisaggRouter(lambda rid: Counted(
        model, params, dataclasses.replace(config, role=roles[rid])),
        len(roles), roles=roles, start_down=(1, 3, 4, 5))
    router.autoscaler = Autoscaler(router, "queue-depth", cooldown=4,
                                   sustain=2, max_replicas={"prefill": 2,
                                                            "decode": 4})
    queue, trace, explicit = _fresh(reqs), [], None
    second = min(t for t in BURSTS if t > 1 and t - 1 not in BURSTS)
    t0 = time.perf_counter()
    with _Launches(totals):
        while queue or sum(router._pending_counts()) or \
                router.tick_count < max(BURSTS):
            for _ in range(BURSTS.get(router.tick_count + 1, 0)):
                router.submit(queue.pop(0))
            router.step()
            states = "".join(router.replica_state(r)[0]
                             for r in range(len(roles)))
            if not trace or trace[-1][1] != states:
                trace.append((router.tick_count, states))
            busy = [len(router.placed[r]) for r in range(len(roles))
                    if roles[r] == "decode"
                    and router.replica_state(r) == "up"]
            if (explicit is None and router.tick_count > second
                    and not any(r[1] == "decode" for r in releases)
                    and len(busy) > 1 and min(busy) > 0):
                explicit = (router.tick_count,
                            router.begin_scale_down("decode"))
            if router.tick_count > 3000:
                raise AssertionError("(d): the router stalled")
        done = router.run(max_ticks=1)
    wall = time.perf_counter() - t0
    sc = router.autoscaler
    migrated = [r for r in releases if r[1] == "decode"]
    _log(f"[cluster] autoscale: {len(done)}/{n} requests in "
         f"{router.tick_count} ticks, {wall:.3f}s; events "
         f"{[(e.tick, e.role, e.action, e.replica) for e in sc.events]}; "
         f"replica states (p p d d d d; u=up d=down r=draining) by tick "
         f"{trace}; releases by a retiring decode replica (tick, role, "
         f"request) {migrated}; explicit scale-down (tick, replica) "
         f"{explicit}; handoffs {router.stats()['handoffs_done']}")
    ups = [e for e in sc.events if e.action == "up" and e.role == "decode"]
    downs = [e for e in sc.events
             if e.action == "down" and e.role == "decode"]
    if not (ups and downs and ups[0].tick < downs[-1].tick and migrated):
        raise AssertionError("(d): decode must scale up, then down, and a "
                             "retiring replica release its requests")
    _first_difference(model, params, reqs, _streams(done), want,
                      "autoscale")
    _log("[cluster] autoscale: streams equal the unified engine's bitwise")
    _balanced(router, "autoscale")
    del router
    _free_device()


def _cluster_launcher():
    """(e) The launcher's chaos path as a subprocess on the card (the full
    config): exit 0, every request finished, at least one recovery."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "internlm2-1.8b", "--replicas", "2", "--cache", "paged",
           "--fault-schedule", "6:kill:1,14:rejoin:1"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    _log(f"[cluster] launcher ({' '.join(cmd[2:])}): exit {res.returncode} "
         f"in {time.perf_counter() - t0:.1f}s; {lines}")
    cl = next((ln for ln in lines if ln.startswith("cluster:")), "")
    fields = dict(f.split("=", 1) for f in cl.split()[1:] if "=" in f)
    done, _, total = fields.get("finished", "0/1").partition("/")
    if (res.returncode or done != total
            or int(fields.get("recoveries", 0)) < 1):
        _log(res.stderr[-3000:])
        raise AssertionError("the cluster launcher failed, lost a request "
                             "or recovered none")


def phase_cluster(smi):
    """Phase 14: the serving cluster on internlm2-1.8b at full width,
    ``CLUSTER_LAYERS`` of 24 layers.  Returns the engine kernels'
    launches, keyed as phase 3's rows."""
    model, params = make_model(num_layers=CLUSTER_LAYERS)
    totals = {}
    for label, part in (("14a router", _cluster_chaos),
                        ("14b disagg paged", lambda m, p, t: _disagg_paged(
                            m, p, t, smi)),
                        ("14c disagg dense", _disagg_dense),
                        ("14d autoscale", _autoscaled)):
        t0 = time.perf_counter()
        part(model, params, totals)
        _log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    del model, params
    _free_device()
    _cluster_launcher()
    _log(f"[time] 14e launcher: {time.perf_counter() - t0:.1f} s")
    _log(f"[cluster] launches: {totals}")
    return totals


# ------------------------------------------------------------ 15: training
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_CUT = dict(layers=2, batch=2, seq=256)  # (a): 315,369,472 parameters
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 6  # (b): full width and depth
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# (a) card against CPU, f32 both ways (TF32 off): cuBLAS and the CPU's
# GEMMs sum 2048- to 8192-long products in other orders, through 2 layers,
# the remat's recompute and a 92544-row unembedding: per leaf,
# max|g_card - g_cpu| <= CARD_GRAD_RTOL * max|g_cpu| + CARD_GRAD_ATOL.
CARD_GRAD_RTOL, CARD_GRAD_ATOL = 1e-3, 1e-9
CARD_LOSS_RTOL = 1e-5
# one AdamW step on the card against the CPU from the same gradients: the
# f32 elementwise ops round alike, but the bias corrections' pow and the
# global norm's sums may differ by an ulp (measured: mu and nu bitwise,
# the master within 7% of this bound)
ADAMW_RTOL = 1e-6
# (c) the examples/train_lm.py model (dim 640, 12 layers, 8/4 heads, vocab
# 32768: 94,715,520 parameters), seq 256, batch 8, grad_accum 2, as there
RESTART = dict(num_layers=12, d_model=640, num_heads=8, num_kv_heads=4,
               head_dim=80, d_ff=2560, vocab_size=32768)
RESTART_STEPS, RESTART_FAIL_AT = 20, 12
# the resumed run's metrics against the uninterrupted run's: the same ops
# on the same data from a bitwise-restored state (the embedding's backward
# sums in a fixed order), so a bitwise run is expected; the bound covers a
# library kernel that sums with atomics, ~1e-7 a step over 10 steps
RESUME_RTOL = 1e-5


def _train_knobs(seq):
    """The training launcher's knobs at sequence length ``seq``."""
    from repro_torch.models import RuntimeKnobs

    return RuntimeKnobs(cache_dtype=torch.float32, q_chunk=min(128, seq),
                        ce_chunk=min(256, seq))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _flat(tree).values())


def _loss_and_grads(model, params, batch):
    """(loss, grads tree) of ``model.loss`` on a copy of ``params`` that
    requires grad (zeros for a leaf the loss does not read)."""
    from repro_torch.optim.adamw import tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    loss.backward()
    return loss.detach(), tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, live)


def _held(label, got, want, rtol, atol):
    """Per leaf, max|got - want| <= rtol * max|want| + atol; logs the worst
    leaf's share of its bound."""
    worst, where = 0.0, ""
    got = _flat(got)
    for key, w in _flat(want).items():
        g = got[key].to(w.device)
        bound = rtol * float(w.abs().max()) + atol
        err = float((g - w).abs().max())
        ratio = err / bound if bound else float(err > 0) * float("inf")
        if ratio > worst:
            worst, where = ratio, key
    _log(f"[train] {label}: worst leaf {where} at {worst:.3f} of its bound "
         f"({rtol:g} x max + {atol:g})")
    if worst > 1:
        raise AssertionError(f"{label}: {where} off by {worst:.2f}x its "
                             f"bound")


def _kernel_launches():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    return [fn.launches for fn in (*_all_kernels(), flash_attention_cuda,
                                   ssd_chunk_cuda)]


def _train_card_vs_cpu():
    """(a) internlm2-1.8b at full width, 2 of 24 layers: the loss and every
    leaf's gradient on the card against the CPU route from the same
    params; one AdamW step from the card's gradients on the card and on
    the CPU; grad_accum 2 against 1 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovSynthetic
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.steps import make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_CUT["layers"])
    knobs = _train_knobs(TRAIN_CUT["seq"])
    cpu = LM(cfg, knobs, device="cpu")
    card = LM(cfg, knobs, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_card = tree_map(lambda t: t.to("cuda"), p_cpu)
    batch = {k: torch.as_tensor(v) for k, v in MarkovSynthetic(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_CUT["seq"],
        global_batch=TRAIN_CUT["batch"], seed=0).batch(0).items()}
    t0 = time.perf_counter()
    l_cpu, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_card, g_card = _loss_and_grads(card, p_card, batch)
    torch.cuda.synchronize()
    _log(f"[train] (a) {cfg.name} {cfg.num_layers} layers, "
         f"{cfg.param_count():,} parameters, B={TRAIN_CUT['batch']} "
         f"S={TRAIN_CUT['seq']}: loss card {float(l_card):.7f} cpu "
         f"{float(l_cpu):.7f}; forward + backward {t_cpu:.1f} s on the CPU, "
         f"{time.perf_counter() - t0:.2f} s on the card (first call)")
    if abs(float(l_card) - float(l_cpu)) > CARD_LOSS_RTOL * abs(float(l_cpu)):
        raise AssertionError("(a) the card's loss differs from the CPU's")
    _held("(a) grads card vs cpu", g_card, g_cpu, CARD_GRAD_RTOL,
          CARD_GRAD_ATOL)
    # one AdamW step from the card's gradients, on the card and on the CPU:
    # the same elementwise f32 ops (IEEE division and square root) on the
    # same inputs, so bitwise is expected
    opt = AdamWConfig(**TRAIN_OPT)
    s_cpu, s_card = adamw_init(p_cpu), adamw_init(p_card)
    _, s_cpu, m_cpu = adamw_update(tree_map(lambda g: g.cpu(), g_card),
                                   s_cpu, opt)
    _, s_card, m_card = adamw_update(g_card, s_card, opt)
    same = all(torch.equal(_flat(s_card[part])[k].cpu(), v)
               for part in ("master", "mu", "nu")
               for k, v in _flat(s_cpu[part]).items())
    _log(f"[train] (a) AdamW step from the card's gradients, card against "
         f"CPU: master, mu and nu {'bitwise equal' if same else 'differ'}; "
         f"grad_norm {float(m_card['grad_norm']):.7f} / "
         f"{float(m_cpu['grad_norm']):.7f}")
    for part in ("master", "mu", "nu"):
        _held(f"(a) AdamW {part}", s_card[part], s_cpu[part], ADAMW_RTOL,
              0.0)
    del s_cpu, s_card, g_cpu, g_card
    # grad_accum 2 (microbatches of one row) against 1 on the card
    out = {}
    for accum in (1, 2):
        state = {"params": tree_map(lambda t: t.clone(), p_card),
                 "opt": adamw_init(p_card)}
        state, met = make_train_step(card, opt, accum)(state, batch)
        out[accum] = (state["opt"]["mu"], met)
    (mu1, met1), (mu2, met2) = out[1], out[2]
    _log(f"[train] (a) grad_accum 1 / 2 on the card: loss "
         f"{float(met1['loss']):.7f} / {float(met2['loss']):.7f}, grad_norm "
         f"{float(met1['grad_norm']):.6f} / {float(met2['grad_norm']):.6f}")
    if abs(float(met2["loss"]) - float(met1["loss"])) \
            > CARD_LOSS_RTOL * float(met1["loss"]):
        raise AssertionError("(a) grad_accum 2 changed the loss")
    mu_atol = (1 - 0.9) * min(1.0, 1.0 / float(met1["grad_norm"])) \
        * CARD_GRAD_ATOL
    _held("(a) mu, grad_accum 2 vs 1", mu2, mu1, CARD_GRAD_RTOL, mu_atol)
    del cpu, card, p_cpu, p_card, out, mu1, mu2
    _free_device()


def _gb(n):
    return f"{n / 1e9:.2f} GB"


def _train_full(smi):
    """(b) internlm2-1.8b at full width and depth: ``TRAIN_STEPS`` steps of
    the ``Trainer`` on ``MarkovSynthetic``, timed and checked; then a step
    with the stacked layer leaves indexed per layer against the default
    ``unbind``, and one step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovSynthetic
    from repro_torch.models import LM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import TrainConfig, Trainer

    cfg = get_config(TRAIN_ARCH)
    model = LM(cfg, _train_knobs(TRAIN_S), device="cuda")
    data = MarkovSynthetic(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=0, noise=0.1)
    trainer = Trainer(model, data, TrainConfig(
        steps=TRAIN_STEPS, log_every=1, checkpoint_every=0,
        opt=AdamWConfig(**TRAIN_OPT)))
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flat(state["params"]).values())
    p_bytes, o_bytes = _tree_bytes(state["params"]), _tree_bytes(state["opt"])
    _log(f"[train] (b) {cfg.name}: {cfg.num_layers} layers, {n_params:,} "
         f"parameters (param_count {cfg.param_count():,}), B={TRAIN_B} "
         f"S={TRAIN_S}, q_chunk {model.knobs.q_chunk}, ce_chunk "
         f"{model.knobs.ce_chunk}, remat {model.knobs.remat}; init "
         f"{time.perf_counter() - t0:.1f} s; params {_gb(p_bytes)}, "
         f"optimizer state {_gb(o_bytes)}, grads {_gb(p_bytes)} "
         f"(f32, held through the update); {smi}")
    before = {k: float(v.double().sum())
              for k, v in _flat(state["params"]).items()}
    tokens = TRAIN_B * TRAIN_S
    flop = 6 * n_params * tokens
    clock = [0.0]
    times, peaks = [], []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - clock[0])
        clock[0] = now
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    launched = _kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    clock[0] = time.perf_counter()
    hist = trainer.run(on_step=on_step)["history"]
    for h, sec, peak in zip(hist, times, peaks):
        _log(f"[train] (b) step {h['step']}: loss {h['loss']:.5f} grad_norm "
             f"{h['grad_norm']:.5f} lr {h['lr']:.3g}; {sec:.3f} s host clock "
             f"(synchronized), {tokens / sec:,.0f} tokens/s, model "
             f"{flop / sec / 1e12:.1f} TFLOP/s (6 N tokens: the remat's "
             f"recomputed forward and the attention products not counted); "
             f"peak {_gb(peak)} = params {_gb(p_bytes)} + optimizer "
             f"{_gb(o_bytes)} + grads {_gb(p_bytes)} + activations and "
             f"temporaries {_gb(peak - 2 * p_bytes - o_bytes)}")
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"(b) step {h['step']}: {h}")
    if len(hist) != TRAIN_STEPS:
        raise AssertionError(f"(b) {len(hist)} steps logged")
    same = [k for k, v in _flat(trainer.state["params"]).items()
            if float(v.double().sum()) == before[k]]
    if same:
        raise AssertionError(f"(b) params unchanged: {same}")
    if _kernel_launches() != launched:
        raise AssertionError("(b) the training route launched a kernel")
    _log(f"[train] (b) every leaf changed; loss {hist[0]['loss']:.5f} -> "
         f"{hist[-1]['loss']:.5f}; no kernel launched")
    # the stacked leaves taken apart once (unbind) against indexed per layer
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    unbind = transformer.unstack_layers

    def indexed(blocks, layers):
        return [transformer._index_tree(blocks[layer.stack], layer.index)
                for layer in layers]

    def one_step():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer.step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t, torch.cuda.max_memory_allocated()

    ab = {"unbind": [], "index": []}
    try:
        for way in ("unbind", "index", "index", "unbind"):
            transformer.unstack_layers = unbind if way == "unbind" \
                else indexed
            ab[way].append(one_step())
    finally:
        transformer.unstack_layers = unbind
    for way, runs in ab.items():
        _log(f"[train] (b) stacked leaves by {way}: "
             + ", ".join(f"{s:.3f} s (peak {_gb(m)})" for s, m in runs))
    _profile_tick(lambda: trainer.step_fn(trainer.state, batch),
                  "15b train step", ticks=1, top=12)
    del trainer, state, model
    _free_device()
    return {"times": times, "peaks": peaks}


# (f) the dry run's peak (the bytes live before the step plus the most it
# allocates at once, counted on the meta device) against (b)'s
# max_memory_allocated: the allocator rounds each block up (512 bytes)
# and cuBLAS takes its workspace from it, and a kernel's own scratch is
# not an output the counter sees; measured 46.88 GB counted against 46.95
# GB in PR 24's runs, so 2% is room and still catches a missed gradient
# or optimizer buffer (7.6 GB each here)
DRY_PEAK_RTOL = 0.02


def _train_dryrun(measured, smi):
    """(f) (b)'s step traced on the meta device at a world of one."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import TraceCounter, roofline
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import init_train_state, make_train_step

    model = LM(get_config(TRAIN_ARCH), _train_knobs(TRAIN_S), device="meta")
    state = init_train_state(model, torch.Generator())
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT))
    batch = {"tokens": torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32,
                                   device="meta")}
    counter = TraceCounter()
    counter.track_args(state, batch)
    t0 = time.perf_counter()
    with counter:
        step(state, batch)
    trace_s = time.perf_counter() - t0
    c = counter.summary()
    terms = roofline(c["flops_by_class"], c["hbm_bytes"], c)
    peak = c["mem_args_bytes"] + c["mem_temp_bytes"]
    step_s = statistics.median(measured["times"])
    real = statistics.median(measured["peaks"])
    _log(f"[dryrun] (f) {TRAIN_ARCH} B={TRAIN_B} S={TRAIN_S} f32 remat, "
         f"traced on meta in {trace_s:.1f} s ({c['n_ops']} ops): "
         f"{c['flops']:.4e} flops ({c['flops_by_class']}), "
         f"{c['hbm_bytes']:.4e} HBM bytes; args {_gb(c['mem_args_bytes'])} "
         f"+ temp {_gb(c['mem_temp_bytes'])} = predicted peak {_gb(peak)} "
         f"against measured max_memory_allocated {_gb(real)} (median of "
         f"(b)'s steps; {(peak - real) / real:+.4f}); roofline compute "
         f"{terms['compute_s']:.3f} s, memory {terms['memory_s']:.3f} s, "
         f"step {terms['step_s']:.3f} s ({terms['bottleneck']}) against "
         f"the measured step {step_s:.3f} s (median, host clock "
         f"synchronized; {terms['step_s'] / step_s:.3f} of it); {smi}")
    if abs(peak - real) > DRY_PEAK_RTOL * real:
        raise AssertionError(f"(f) predicted peak {peak} against measured "
                             f"{real}: past DRY_PEAK_RTOL")
    if step_s < terms["step_s"]:
        raise AssertionError(f"(f) measured step {step_s} s faster than "
                             f"the roofline's {terms['step_s']} s")


def _timed_trainer(log):
    """A ``Trainer`` class that times its checkpoint saves and restores
    (synchronized) into ``log``."""
    from repro_torch.runtime.train import Trainer

    class TimedTrainer(Trainer):
        def save(self):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super().save()
            log.append(("save", self.step, time.perf_counter() - t))

        def maybe_restore(self):
            t = time.perf_counter()
            ok = super().maybe_restore()
            torch.cuda.synchronize()
            if ok:
                log.append(("restore", self.step, time.perf_counter() - t))
            return ok

    return TimedTrainer


def _train_restart():
    """(c) examples/train_lm.py's model: ``run_with_failures`` with a
    failure at step ``RESTART_FAIL_AT`` resumes from the last checkpoint
    and finishes; its history against an uninterrupted run's."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import MarkovSynthetic
    from repro_torch.models import LM, RuntimeKnobs
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault import FailureInjector, run_with_failures
    from repro_torch.runtime.train import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **RESTART)
    model = LM(cfg, RuntimeKnobs(cache_dtype=torch.float32, q_chunk=128,
                                 ce_chunk=256), device="cuda")
    data = MarkovSynthetic(vocab_size=cfg.vocab_size, seq_len=256,
                           global_batch=8, seed=0, noise=0.1)
    tcfg = dict(steps=RESTART_STEPS, grad_accum=2, log_every=1,
                opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                total_steps=RESTART_STEPS))
    t0 = time.perf_counter()
    whole = Trainer(model, data, TrainConfig(checkpoint_every=0, **tcfg))
    want = {h["step"]: h for h in whole.run()["history"]}
    t_whole = time.perf_counter() - t0
    del whole
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    log = []
    timed_trainer = _timed_trainer(log)
    try:
        t0 = time.perf_counter()
        out = run_with_failures(
            lambda attempt: timed_trainer(model, data, TrainConfig(
                checkpoint_every=5, keep_checkpoints=2, checkpoint_dir=tmp,
                **tcfg)),
            injector=FailureInjector(fail_at_steps=(RESTART_FAIL_AT,)))
        t_run = time.perf_counter() - t0
        kept = sorted(os.listdir(tmp))
        size = os.path.getsize(os.path.join(tmp, kept[-1], "arrays.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out["restarts"] != 1 or out["step"] != RESTART_STEPS:
        raise AssertionError(f"(c) restarts {out['restarts']}, step "
                             f"{out['step']}")
    got = out["history"]
    if [h["step"] for h in got] != list(range(11, RESTART_STEPS + 1)):
        raise AssertionError(f"(c) resumed steps {[h['step'] for h in got]}")
    worst = max(abs(h[k] - want[h["step"]][k]) / abs(want[h["step"]][k])
                for h in got for k in ("loss", "grad_norm"))
    bitwise = all(h == want[h["step"]] for h in got)
    _log(f"[train] (c) {cfg.param_count():,} parameters: uninterrupted "
         f"{RESTART_STEPS} steps {t_whole:.1f} s; with a failure at step "
         f"{RESTART_FAIL_AT}: restarts {out['restarts']}, resumed at step "
         f"11, {t_run:.1f} s; kept {kept}; checkpoint {size:,} bytes; "
         + ", ".join(f"{what} at step {s} {sec:.2f} s"
                     for what, s, sec in log))
    _log(f"[train] (c) resumed history against the uninterrupted run: "
         f"{'bitwise equal' if bitwise else 'not bitwise'}, worst relative "
         f"difference {worst:.3g} (loss, grad_norm; bound {RESUME_RTOL:g}); "
         f"use_deterministic_algorithms="
         f"{torch.are_deterministic_algorithms_enabled()}")
    if worst > RESUME_RTOL:
        raise AssertionError("(c) the resumed run left the uninterrupted one")
    del model
    _free_device()


TRAIN_LAUNCHER_CMD = [sys.executable, "-m", "repro_torch.launch.train",
                      "--arch", TRAIN_ARCH, "--smoke", "--steps", "30"]


def _train_launcher():
    """(d) ``python -m repro_torch.launch.train --arch internlm2-1.8b
    --smoke --steps 30`` on the card (started beside the build, as it
    needs no kernel): exit 0, the last logged loss below the first."""
    cmd = TRAIN_LAUNCHER_CMD
    res, secs = _reap(_EARLY.pop("train", None) or _spawn(cmd), 600)
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    _log(f"[train] (d) launcher ({' '.join(cmd[2:])}): exit "
         f"{res.returncode} in {secs:.1f}s since its start; {lines}")
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step ")]
    if res.returncode or len(losses) < 2 or losses[-1] >= losses[0]:
        _log(res.stderr[-3000:])
        raise AssertionError("(d) the training launcher failed or its loss "
                             "did not fall")


def _train_guard():
    """(e) #6's and #7's wrappers on the card, an input requiring grad:
    each raises by name and launches nothing."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    q = torch.randn(1, 256, H, D, device="cuda", requires_grad=True)
    k = torch.randn(1, 256, KV, D, device="cuda")
    x = torch.randn(1, 1, 8, 64, 64, device="cuda", requires_grad=True)
    bc = torch.randn(1, 1, 1, 64, 64, device="cuda")
    dt = torch.rand(1, 1, 8, 64, device="cuda")
    launched = _kernel_launches()
    for name, call in (("flash_attention_cuda",
                        lambda: flash_attention_cuda(q, k, k)),
                       ("ssd_chunk_cuda",
                        lambda: ssd_chunk_cuda(x, bc, bc, dt,
                                               dt.cumsum(-1)))):
        try:
            call()
        except RuntimeError as e:
            if f"{name} is forward only" not in str(e):
                raise
            _log(f"[train] (e) {name} on an input requiring grad: raised "
                 f"({e})")
        else:
            raise AssertionError(f"(e) {name} took an input requiring grad")
    if _kernel_launches() != launched:
        raise AssertionError("(e) a refused call launched a kernel")


def phase_train(smi):
    """Phase 15: training on the card (no kernel on its path)."""
    _free_device()
    measured = {}
    for label, part in (("15a card vs cpu", _train_card_vs_cpu),
                        ("15b full width and depth",
                         lambda: measured.update(_train_full(smi))),
                        ("15c restart", _train_restart),
                        ("15d launcher", _train_launcher),
                        ("15e guard", _train_guard),
                        ("15f dry run", lambda: _train_dryrun(measured,
                                                              smi))):
        t0 = time.perf_counter()
        part()
        _log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------- 16: sharded serving
SHARD_MESHES = ((2, 2), (1, 2))  # (1, 2) restores (2, 2)'s checkpoint
SHARD_LAYERS = 8  # of 24: the served model's depth (the run's time limit)
SHARD_SLOTS, SHARD_LEN, SHARD_CHUNK, SHARD_PAGE = 4, 2048, 256, 16
SHARD_REQUESTS = 4  # one wave of the 4 slots: the run's time pays per tick
SHARD_NEW = (12, 21)  # new tokens a request, drawn from [12, 21)
SHARD_TIMEOUT = 420  # seconds for one spawned world, every rank included
SHARD_PROBE_LEN = 300  # the logits probe's prompt
# the preemption flood: gold's 6 requests, free's 2 two ticks later
SHARD_FLOOD = dict(policy="drf-fair", tenant_weights={"gold": 3, "free": 1},
                   preempt=True, victim_policy="lowest-weight-share-first")


def _shard_cases(shape, drafter=None):
    """(name, ServeConfig kwargs) of the engines one world serves: paged,
    and at (2, 2) dense, the preemption flood on a paged pool and the
    speculative paged engine with ``drafter`` (``_shard_drafter``)."""
    base = dict(batch_slots=SHARD_SLOTS, max_len=SHARD_LEN,
                prefill_chunk=SHARD_CHUNK)
    paged = dict(base, cache="paged", page_size=SHARD_PAGE)
    if shape != (2, 2):
        return [("paged", paged)]
    cases = [("dense", base), ("paged", paged),
             ("preempt", dict(paged, **SHARD_FLOOD))]
    if drafter is not None:
        cases.append(("spec", dict(paged, draft_k=3, drafter=drafter)))
    return cases


def _shard_flood(vocab):
    """The preemption flood's requests: 8 prompts of 3-19 tokens, 12 new
    tokens each, odd ones seeded-sampled; the first 6 of tenant "gold",
    the last 2 of tenant "free", submitted two ticks later.  Returns
    (first, late)."""
    from repro_torch.runtime.serve import Request, SamplingParams

    rng = np.random.default_rng(7)
    out = []
    for i in range(8):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 20)))
        sp = (SamplingParams(temperature=0.8, top_k=20, seed=i) if i % 2
              else SamplingParams())
        out.append(Request(i, prompt.astype(np.int32), max_new_tokens=12,
                           sampling=sp, tenant="gold" if i < 6 else "free"))
    return out[:6], out[6:]


def _shard_case_requests(name, vocab):
    """(first, late) requests of a case: the flood's for "preempt", else
    ``_shard_requests`` all at once."""
    if name == "preempt":
        return _shard_flood(vocab)
    return _shard_requests(vocab), []


def _shard_drafter(reqs, plain, vocab):
    """The replay drafter of the unsharded paged engine's streams: the
    random weights never repeat their context, so the n-gram drafter would
    propose nothing and no verify block would run."""
    return _replay_drafter([r.prompt for r in reqs],
                           [plain[r.req_id] for r in reqs], vocab)


def _shard_requests(vocab):
    """Prompts of 200-900 tokens, 12-20 new tokens each; odd requests
    seeded-sampled (temperature 0.8, top-p 0.9), even ones greedy."""
    from repro_torch.runtime.serve import Request, SamplingParams

    rng = np.random.default_rng(16)
    out = []
    for i in range(SHARD_REQUESTS):
        prompt = rng.integers(0, vocab, size=int(rng.integers(200, 901)))
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=7) if i % 2
              else SamplingParams())
        out.append(Request(i, prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(*SHARD_NEW)),
                           sampling=sp))
    return out


def _shard_probe(model, params, slots, lo=0):
    """The logits probe: each of ``slots`` local slots prefills a seeded
    ``SHARD_PROBE_LEN``-token prompt (its global slot's) in chunks, then
    all take one decode step.  Returns (last prefill rows (slots, V),
    decode logits (slots, V)) on the CPU."""
    caches = model.init_cache(slots, SHARD_LEN)
    rng = np.random.default_rng(160)
    prompts = rng.integers(0, model.cfg.vocab_size,
                           size=(SHARD_SLOTS, SHARD_PROBE_LEN)).astype(
                               np.int32)
    c, n = SHARD_CHUNK, -(-SHARD_PROBE_LEN // SHARD_CHUNK)
    last, nxt = [], []
    for s in range(slots):
        padded = np.zeros(n * c, np.int32)
        padded[:SHARD_PROBE_LEN] = prompts[lo + s]
        for ci in range(n):
            logits, caches = model.prefill_chunk_step(
                params, caches, padded[None, ci * c:(ci + 1) * c], s, ci * c)
        row = logits[SHARD_PROBE_LEN - 1 - (n - 1) * c]
        last.append(row)
        nxt.append(int(row.argmax()))
    dec, _ = model.decode_step(
        params, caches, np.asarray(nxt, np.int32)[:, None],
        np.full(slots, SHARD_PROBE_LEN, np.int32))
    return torch.stack(last).cpu(), dec.cpu()


def _shard_kernel_checks(eng, seed):
    """Each kernel of the rank's path against its plain version at the
    rank's shard shape, on its own cache after the run: #1 (and #2 at 2
    splits) on the dense stripes, #3 (#5 at 2 splits, T = 4 rows) and #4
    on its pools through a random table of its pages.  Returns {kernel:
    max_abs_err}; raises past TOL."""
    from repro_torch.kernels import ops

    cfg = eng.model.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    slots = eng._hi - eng._lo
    # room for T = 4 rows behind each position
    pos = torch.tensor([(SHARD_LEN - 4 - 611 * i) % (SHARD_LEN - 4)
                        for i in range(slots)], dtype=torch.int32,
                       device="cuda")
    errs = {}

    def held(name, got, want):
        err = float((got - want).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        if not (torch.isfinite(got).all() and err <= TOL[torch.float32]):
            raise AssertionError(f"{name} at the shard shape: max_abs_err "
                                 f"{err:.3g} (tol {TOL[torch.float32]})")

    layer = {k: v[0] for k, v in eng.caches["stack"].items()}
    k, v = layer["k"], layer["v"]
    for t in (1, 4):
        q = torch.randn((slots, t, cfg.num_heads, cfg.head_dim),
                        generator=g, device="cuda")
        if eng.kv is None:
            for splits in ((1, 2) if t == 1 else (1,)):
                name = ("decode_attention" if splits == 1
                        else "decode_attention_splitk")
                held(name, ops.decode_attention(q, k, v, pos,
                                                num_splits=splits),
                     ops.decode_attention_plain(q, k, v, pos,
                                                num_splits=splits))
            continue
        n_pages = k.shape[0]
        table = torch.stack([
            1 + torch.randperm(n_pages - 1, generator=g, device="cuda")[
                :SHARD_LEN // SHARD_PAGE] for _ in range(slots)]).to(
                    torch.int32)
        for splits in ((1, 2) if t == 1 else (1,)):
            name = ("paged_decode_attention" if splits == 1
                    else "paged_decode_attention_splitk")
            held(name, ops.paged_decode_attention(
                q, k, v, table, pos, num_splits=splits),
                ops.paged_decode_attention_plain(q, k, v, table, pos,
                                                 num_splits=splits))
        if t == 1:
            qc = torch.randn((1, SHARD_CHUNK, cfg.num_heads, cfg.head_dim),
                             generator=g, device="cuda")
            off = SHARD_LEN // 4
            held("paged_prefill_attention",
                 ops.paged_prefill_attention(qc, k, v, table, 0, off),
                 ops.paged_prefill_attention_plain(qc, k, v, table, 0, off))
    return errs


def _shard_serve(eng, reqs, late=()):
    """Serve ``reqs`` tick by tick, ``late`` submitted after two ticks;
    returns (streams, launches, verify launches, per-tick host ms,
    per-tick CUDA-event ms)."""
    for r in reqs:
        eng.submit(r)
    late = list(late)
    kernels = _all_kernels()
    verify = (kernels[0], kernels[2])  # the decode kernels' T > 1 counts
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    for kern in verify:
        kern.verify_launches = 0
    host, dev = [], []
    while late or eng.queue or any(r is not None for r in eng.active):
        if len(host) == 2:
            for r in late:
                eng.submit(r)
            late = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        eng.step()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
        if len(host) > 5000:
            raise AssertionError("sharded engine did not drain")
    launches = {k.__name__.removesuffix("_cuda"): k.launches
                for k in kernels}
    vl = {k.__name__.removesuffix("_cuda"): k.verify_launches
          for k in verify}
    done = eng.run()
    return _streams(done), launches, vl, host, dev


def _shard_rank():
    """One rank of a phase-16 world (``chip_smoke.py --shard-rank``, its
    rank, world, mesh shape, rendezvous and output directory in the
    environment): build or load the kernels (rank 0 first), draw the full
    weights, serve every case on ``ServeEngine(mesh=...)``, check each
    kernel at the shard shape, run the logits probe, and write its record.
    Any failure raises, and the rank exits non-zero."""
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    shape = tuple(int(s) for s in os.environ["SHARD_SHAPE"].split(","))
    out_dir = Path(os.environ["SHARD_OUT"])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=os.environ["SHARD_INIT"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=SHARD_TIMEOUT))
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    if rank == 0:
        _build.build_all()  # phase 2 built them: this loads
    dist.barrier()
    if rank:
        _build.build_all()
    model, params = make_model(num_layers=SHARD_LAYERS)
    mesh = make_serve_mesh(shape)
    with open(out_dir / "plain.json") as f:
        plain = {int(k): v for k, v in json.load(f).items()}
    drafter = _shard_drafter(_shard_requests(model.cfg.vocab_size), plain,
                             model.cfg.vocab_size)
    rec = {"rank": rank, "coord": list(mesh.get_coordinate()),
           "backend": dist.get_backend(), "setup_s":
           time.perf_counter() - t0, "cases": {}}
    for name, kw in _shard_cases(shape, drafter):
        eng = ServeEngine(model, params, ServeConfig(**kw), mesh=mesh)
        streams, launches, vl, host, dev = _shard_serve(
            eng, *_shard_case_requests(name, model.cfg.vocab_size))
        case = {"streams": {str(k): v for k, v in streams.items()},
                "launches": launches, "verify_launches": vl,
                "heads": eng.model.cfg.num_heads,
                "kv_heads": eng.model.cfg.num_kv_heads,
                "slots": [eng._lo, eng._hi], "hosts": eng._num_hosts,
                "tick_host_ms": host, "tick_dev_ms": dev,
                "errs": _shard_kernel_checks(eng, seed=rank)}
        if eng.scheduler.preempt:
            case["preempted"] = eng.scheduler.preempted_total
            case["moved"] = eng.moved_across_rows
        if eng.draft_k:
            st = eng.spec_stats()
            case["spec"] = {k: st[k] for k in ("spec_ticks", "proposed",
                                               "accepted", "acceptance_rate")}
        if eng.kv is not None:
            case["pages"] = int(eng.caches["stack"]["k"].shape[1])
            off = eng.offer()
            case["free_pages_by_host"] = off.get("free_pages_by_host")
            case["free_pages"] = off["free_pages"]
        if name == _shard_cases(shape)[0][0]:  # once a world
            last, dec = _shard_probe(eng.model, eng.params,
                                     eng._hi - eng._lo, eng._lo)
            if mesh.get_coordinate()[-1] == 0:
                torch.save({"lo": eng._lo, "last": last, "decode": dec},
                           out_dir / f"probe_{eng._lo}.pt")
        rec["cases"][name] = case
        del eng
        _free_device()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, params
    _free_device()
    rec["train"] = _shard_train(shape, mesh, out_dir.parent)
    with open(out_dir / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.barrier()


# phase 16's training part: internlm2-1.8b at full width, 2 of 24 layers
# (phase 15a's depth), B = 4 x 512, inside the phase's worlds
SHARD_TRAIN = dict(layers=2, batch=4, seq=512, steps=2)
SHARD_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=4)
# the sharded step against the unsharded one on the card: the loss and
# grad_norm (gloo sums the data ranks' gradients in another order than
# one GEMM sums the rows); the params after the steps element by element:
# AdamW moves an element by about lr a step whatever its gradient's size,
# so an element whose gradient lies near 0 may move either way on either
# side (at most 2 lr a step); every other one within SHARD_PARAM_ATOL.
# A leaf may hold at most SHARD_NEAR0_FRAC of its elements past that.
SHARD_LOSS_RTOL, SHARD_NORM_RTOL = 1e-5, 1e-4
SHARD_PARAM_ATOL, SHARD_NEAR0_FRAC = 1e-6, 1e-2
SHARD_COMPRESS_SHAPE = (8192, 2048)  # one layer's w_up
SHARD_PIPE = dict(layers=2, micro=4, rows=256, width=2048)


def _shard_train_model(mesh=None, sp=False):
    """Phase 16's training model: ``TRAIN_ARCH`` at full width, cut to
    ``SHARD_TRAIN["layers"]`` layers, the training launcher's knobs, over
    ``mesh``'s seams when given (``sp``: the sequence-parallel
    residual)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.sharding import make_shard_fn

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=SHARD_TRAIN["layers"])
    knobs = _train_knobs(SHARD_TRAIN["seq"])
    if mesh is not None:
        knobs = knobs.with_(shard_fn=make_shard_fn(mesh, cfg, sp=sp))
    return LM(cfg, knobs, device="cuda")


def _shard_train_data(vocab):
    from repro_torch.data import MarkovSynthetic

    return MarkovSynthetic(vocab_size=vocab, seq_len=SHARD_TRAIN["seq"],
                           global_batch=SHARD_TRAIN["batch"], seed=0)


def _shard_train_reference(ref_dir):
    """The unsharded train step on the card from the phase's init,
    ``grad_accum`` 2 for 3 steps.  Writes each step's loss, grad_norm,
    lr and host ms (``ref.json``) and the params after steps 2 and 3 for
    the ranks to hold theirs against."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.steps import init_train_state, make_train_step

    model = _shard_train_model()
    data = _shard_train_data(model.cfg.vocab_size)
    out = {}
    for accum, n in ((2, SHARD_TRAIN["steps"] + 1),):
        state = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(model, AdamWConfig(**SHARD_TRAIN_OPT), accum)
        mets = []
        for i in range(n):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in data.batch(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            mets.append({"loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"]),
                         "lr": float(met["lr"]),
                         "ms": (time.perf_counter() - t0) * 1e3})
            if i >= 1:
                torch.save(tree_map(lambda t: t.cpu(), state["params"]),
                           ref_dir / f"params_a{accum}_s{i + 1}.pt")
        out[str(accum)] = mets
        opt_bytes = {k: _tree_bytes(state["opt"][k])
                     for k in ("master", "mu", "nu")}
        del state, step
    out["opt_bytes"] = opt_bytes
    out["params"] = model.cfg.param_count()
    with open(ref_dir / "ref.json", "w") as f:
        json.dump(out, f)
    del model
    _free_device()
    return out


def _shard_params_held(label, params, pspec, ref_path, sizes, coord, lrs):
    """Each leaf block of ``params`` against the rank's block of the
    unsharded params at ``ref_path``: every element within 2 sum(lr) +
    SHARD_PARAM_ATOL, at most SHARD_NEAR0_FRAC of a leaf's past
    SHARD_PARAM_ATOL.  Returns (max abs err, worst leaf's share past)."""
    from repro_torch.sharding.rules import shard_block

    ref = _flat(torch.load(ref_path, mmap=True))
    got = _flat(params)
    worst, frac, where = 0.0, 0.0, ""
    for key, r in ref.items():
        r = shard_block(r, pspec[key], sizes, coord).to("cuda")
        err = (got[key].float() - r.float()).abs()
        worst = max(worst, float(err.max()))
        f = float((err > SHARD_PARAM_ATOL).float().mean())
        if f > frac:
            frac, where = f, key
    if worst > 2 * sum(lrs) + SHARD_PARAM_ATOL or frac > SHARD_NEAR0_FRAC:
        raise AssertionError(f"{label}: params off by {worst:.3g} (bound "
                             f"{2 * sum(lrs):.3g}), {frac:.4f} of {where} "
                             f"past {SHARD_PARAM_ATOL}")
    return worst, frac


def _shard_train_steps(label, step, state, data, ref, first=0):
    """Run ``len(ref)`` steps of ``step`` from ``state`` on ``data``'s
    batches from ``first`` and hold each step's loss and grad_norm to the
    unsharded step's.  Returns (state, per-step records)."""
    out = []
    for i, want in enumerate(ref):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(first + i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        rec = {"loss": float(met["loss"]), "grad_norm":
               float(met["grad_norm"]), "ms":
               (time.perf_counter() - t0) * 1e3}
        out.append(rec)
        if (abs(rec["loss"] - want["loss"]) > SHARD_LOSS_RTOL * want["loss"]
                or abs(rec["grad_norm"] - want["grad_norm"])
                > SHARD_NORM_RTOL * want["grad_norm"]):
            raise AssertionError(f"{label} step {first + i + 1}: loss "
                                 f"{rec['loss']!r} grad_norm "
                                 f"{rec['grad_norm']!r} against the "
                                 f"unsharded {want}")
    return state, out


def _shard_compress(mesh):
    """The int8 compressed all-reduce over the data group on CUDA
    tensors: a rank's seeded (8192, 2048) gradient, against the float
    mean; every data rank's result bitwise the others'."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import data_group
    from repro_torch.optim import CompressionState, compress_error_feedback
    from repro_torch.sharding import all_gather_cat

    group = data_group(mesh)
    gen = torch.Generator(device="cuda").manual_seed(dist.get_rank())
    g = {"w": torch.randn(SHARD_COMPRESS_SHAPE, generator=gen,
                          device="cuda")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = compress_error_feedback(g, CompressionState.init(g), group)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    exact = g["w"].clone()
    dist.all_reduce(exact, group=group)
    exact /= dist.get_world_size(group)
    rel = float((out["w"] - exact).abs().max() / exact.abs().max())
    every = all_gather_cat(out["w"][None], group, 0)
    same = all(torch.equal(every[0], e) for e in every)
    if rel > 0.02 or not same:
        raise AssertionError(f"compressed all-reduce: rel err {rel:.4g}, "
                             f"ranks agree {same}")
    return {"rel_err": rel, "ranks_agree": same, "ms": ms}


def _shard_pipeline():
    """A 2-stage ``make_pipelined_forward`` at width 2048 (2 layers of
    tanh(h @ w + b) a stage, 4 microbatches of 256 rows) on the world of
    2, against the sequential stack on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.sharding import make_pipelined_forward

    n, c = dist.get_world_size(), SHARD_PIPE
    mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("stage",))
    gen = torch.Generator(device="cuda").manual_seed(21)
    d = c["width"]
    params = {"w": torch.randn((n, c["layers"], d, d), generator=gen,
                               device="cuda") * d ** -0.5,
              "b": torch.randn((n, c["layers"], d), generator=gen,
                               device="cuda") * 0.1}
    x = torch.randn((c["micro"], c["rows"], d), generator=gen, device="cuda")

    def stage_fn(p, h):
        for w, b in zip(p["w"], p["b"]):
            h = torch.tanh(h @ w + b)
        return h

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = make_pipelined_forward(stage_fn, mesh)(params, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = x
    for s in range(n):
        want = stage_fn({k: v[s] for k, v in params.items()}, want)
    err = float((out - want).abs().max())
    if not torch.isfinite(out).all() or err > 1e-5:
        raise AssertionError(f"pipeline: max_abs_err {err:.3g}")
    return {"max_abs_err": err, "bitwise": torch.equal(out, want), "ms": ms}


def _shard_train(shape, mesh, ref_dir):
    """Phase 16's training part in one rank (see the module docstring);
    returns the rank's record.  Every check raises."""
    import torch.distributed as dist

    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.runtime.train import TrainConfig, Trainer
    from repro_torch.sharding import grad_shardings
    from repro_torch.sharding.rules import (mesh_coord, mesh_sizes,
                                            param_shapes)
    from repro_torch.sharding.zero import state_shardings_of

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with open(ref_dir / "ref.json") as f:
        ref = json.load(f)
    model = _shard_train_model(mesh)
    cfg = model.cfg
    data = _shard_train_data(cfg.vocab_size)
    opt = AdamWConfig(**SHARD_TRAIN_OPT)
    specs = state_shardings_of(model)
    pspec = _flat(specs["params"])
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    ckpt = ref_dir / "ckpt"
    steps = SHARD_TRAIN["steps"]
    rec = {}
    if shape == (2, 2):  # ZeRO-2, grad_accum 2, then the save
        state = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(model, opt, 2, grad_shardings=grad_shardings(
            mesh, cfg, param_shapes(cfg)))
        state, rec["steps"] = _shard_train_steps(
            "zero2", step, state, data, ref["2"][:steps])
        rec["params"] = _shard_params_held(
            "zero2", state["params"], pspec, ref_dir / "params_a2_s2.pt",
            sizes, coord, [m["lr"] for m in ref["2"][:steps]])
        rec["opt_bytes"] = {k: _tree_bytes(state["opt"][k])
                            for k in ("master", "mu", "nu")}
        t0 = time.perf_counter()
        tr = Trainer(model, data, TrainConfig(checkpoint_dir=str(ckpt),
                                              opt=opt), mesh=mesh)
        tr.state, tr.step = state, steps
        tr.save()
        rec["save_s"] = time.perf_counter() - t0
        del state, step, tr
        _free_device()
        rec["compress"] = _shard_compress(mesh)
    else:  # tensor parallel, the elastic restore, the pipeline
        state = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(model, opt, 2)
        state, rec["steps"] = _shard_train_steps(
            "tp", step, state, data, ref["2"][:steps])
        rec["params"] = _shard_params_held(
            "tp", state["params"], pspec, ref_dir / "params_a2_s2.pt",
            sizes, coord, [m["lr"] for m in ref["2"][:steps]])
        rec["opt_bytes"] = {k: _tree_bytes(state["opt"][k])
                            for k in ("master", "mu", "nu")}
        del state, step
        _free_device()
        t0 = time.perf_counter()
        tr = Trainer(model, data, TrainConfig(
            steps=steps + 1, grad_accum=2, checkpoint_every=0,
            checkpoint_dir=str(ckpt), log_every=1, opt=opt), mesh=mesh)
        tr.maybe_restore()
        rec["restore_s"] = time.perf_counter() - t0
        if tr.step != steps:
            raise AssertionError(f"restored step {tr.step}, saved {steps}")
        hist = tr.run()["history"]
        want = ref["2"][steps]
        got = hist[-1]
        rec["resumed"] = {"loss": got["loss"], "grad_norm":
                          got["grad_norm"]}
        if abs(got["loss"] - want["loss"]) > SHARD_LOSS_RTOL * want["loss"]:
            raise AssertionError(f"resumed step {steps + 1}: loss "
                                 f"{got['loss']!r}, unsharded {want}")
        rec["resumed_params"] = _shard_params_held(
            "resumed", tr.state["params"], pspec,
            ref_dir / f"params_a2_s{steps + 1}.pt", sizes, coord,
            [m["lr"] for m in ref["2"]])
        del tr
        _free_device()
        rec["pipeline"] = _shard_pipeline()
        # the sequence-parallel residual from the same init
        sp_model = _shard_train_model(mesh, sp=True)
        state = init_train_state(
            sp_model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(sp_model, opt, 2)
        state, rec["sp_steps"] = _shard_train_steps(
            "sp", step, state, data, ref["2"][:steps])
        rec["sp_params"] = _shard_params_held(
            "sp", state["params"], pspec, ref_dir / "params_a2_s2.pt",
            sizes, coord, [m["lr"] for m in ref["2"][:steps]])
        del state, step, sp_model
        _free_device()
    dist.barrier()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t_start
    del model
    _free_device()
    return rec


def _shard_world(shape, out_dir):
    """Spawn one world of ``prod(shape)`` ranks on ``cuda:0`` (gloo, a
    file rendezvous) and wait for all; a rank that fails, or a world past
    ``SHARD_TIMEOUT``, fails the phase with the rank's output."""
    n = int(np.prod(shape))
    env = {**os.environ, "WORLD_SIZE": str(n),
           "SHARD_SHAPE": ",".join(map(str, shape)),
           "SHARD_OUT": str(out_dir),
           "SHARD_INIT": f"file://{out_dir}/rendezvous"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank"],
        cwd=ROOT, env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            _log(out[-6000:])
            raise AssertionError(f"mesh {shape}: rank {r} exited "
                                 f"{p.returncode}")
    recs = []
    for r in range(n):
        with open(out_dir / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return recs


def _shard_products(model, params):
    """Whether each product the sharded decode cuts keeps its bits on the
    card, at internlm2's shapes: the model's own first-layer weights, a
    4-row decode input cut to 2 rows, and each sharded weight cut to half
    its columns (TP 2).  Returns the names of the products that differ."""
    p = {k: v[0] for k, v in params["blocks"]["stack"]["attn"].items()}
    p.update({k: v[0] for k, v in params["blocks"]["stack"]["mlp"].items()})
    x = torch.randn((SHARD_SLOTS, 1, model.cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    ein = lambda a, w: torch.einsum("bsd,dhk->bshk", a, w)  # noqa: E731
    mm = lambda a, w: a @ w  # noqa: E731
    differ = []
    for name, f, dim in (("wq", ein, 1), ("wk", ein, 1), ("wv", ein, 1),
                         ("w_gate", mm, 1), ("w_up", mm, 1)):
        w = p[name]
        full = f(x, w)
        rows = torch.equal(f(x[2:].contiguous(), w), full[2:])
        n = w.shape[dim] // 2
        part = f(x, w.narrow(dim, n, n).contiguous())
        cols = torch.equal(part, full.narrow(-2 if w.ndim == 3 else -1, n,
                                             n))
        _log(f"[shard] product {name} {tuple(w.shape)}: rows 4 -> 2 "
             f"bitwise {rows}; columns cut in half (TP 2) bitwise {cols}")
        if not (rows and cols):
            differ.append(name)
    return differ


def _shard_differences(model, params, reqs, got, want, label):
    """Each request whose stream differs from the unsharded engine's: the
    first differing position and the top-2 logit margin of the unsharded
    model there (the whole-sequence prefill of the prompt and the agreed
    tokens).  Returns the number of differing requests."""
    n = 0
    for r in reqs:
        a, b = got[str(r.req_id)], want[r.req_id]
        if a == b:
            continue
        n += 1
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        toks = np.concatenate([r.prompt, np.asarray(b[:k], np.int32)])
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
            toks[None], device="cuda")})
        top = torch.topk(logits[0], 2).values
        _log(f"[shard] {label}: request {r.req_id} "
             f"({'sampled' if r.sampling.temperature else 'greedy'}) "
             f"differs first at output position {k} of {len(b)} "
             f"({a[k:k + 1]} against {b[k:k + 1]}); top-2 logit margin "
             f"there {float(top[0] - top[1]):.3g}")
    return n


REFUSAL_CMD = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "internlm2-1.8b", "--tp", "2", "--requests", "2"]
REFUSAL_ENV = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}


def _shard_launcher_refusal():
    """The launcher, ``--tp 2`` in a world of 2 on a machine with fewer
    cards than ranks (started beside the build: it stops before any
    kernel): it must raise the reference's "needs n devices" error, not
    move to gloo or the CPU."""
    res, _ = _reap(_EARLY.pop("refusal", None)
                   or _spawn(REFUSAL_CMD, REFUSAL_ENV), 300)
    said = (res.stderr.strip().splitlines() or [""])[-1]
    _log(f"[shard] launcher --tp 2 on {torch.cuda.device_count()} card(s): "
         f"exit {res.returncode}; {said}")
    if torch.cuda.device_count() < 2 and (
            res.returncode == 0 or "needs 2 devices" not in said):
        raise AssertionError("the launcher did not refuse a world larger "
                             "than the visible cards")


def _shard_train_report(shape, recs, ref, smi):
    """Log each rank's training record of one world (the ranks checked
    their numbers against the unsharded step already)."""
    label = f"mesh {shape[0]}x{shape[1]}"
    case = "ZeRO-2, grad_accum 2" if shape == (2, 2) else \
        "tensor parallel, grad_accum 2"
    want = ref["2"]
    for rec in recs:
        t = rec["train"]
        steps = t["steps"]
        _log(f"[shard-train] {label} rank {rec['rank']} "
             f"{tuple(rec['coord'])} {case}, B={SHARD_TRAIN['batch']} x "
             f"{SHARD_TRAIN['seq']}: loss {[m['loss'] for m in steps]} "
             f"(unsharded {[m['loss'] for m in want[:len(steps)]]}), "
             f"grad_norm {[round(m['grad_norm'], 6) for m in steps]} "
             f"(unsharded {[round(m['grad_norm'], 6) for m in want[:len(steps)]]}); "
             f"params after {len(steps)} steps: max_abs_err "
             f"{t['params'][0]:.3g}, worst leaf's share past "
             f"{SHARD_PARAM_ATOL:g}: {t['params'][1]:.2e}; step host ms "
             f"{[round(m['ms'], 1) for m in steps]} (ranks time-sliced on "
             f"one {smi} over gloo: not a data-parallel speed; unsharded "
             f"{[round(m['ms'], 1) for m in want[:len(steps)]]}); master/"
             f"mu/nu bytes {[t['opt_bytes'][k] for k in ('master', 'mu', 'nu')]}"
             f" against the unsharded "
             f"{[ref['opt_bytes'][k] for k in ('master', 'mu', 'nu')]} "
             f"({t['opt_bytes']['master'] / ref['opt_bytes']['master']:.3f}"
             f"); max_memory_allocated {t['peak_gb']:.2f} GB; "
             f"{t['seconds']:.1f} s")
        if "save_s" in t:
            _log(f"[shard-train] {label} rank {rec['rank']}: checkpoint "
                 f"gathered and written by rank 0 in {t['save_s']:.1f} s; "
                 f"compressed all-reduce over the data group "
                 f"{SHARD_COMPRESS_SHAPE}: rel err "
                 f"{t['compress']['rel_err']:.4g}, ranks bitwise "
                 f"{t['compress']['ranks_agree']}, "
                 f"{t['compress']['ms']:.1f} ms host")
        if "resumed" in t:
            r, p = t["resumed"], t["pipeline"]
            _log(f"[shard-train] {label} rank {rec['rank']}: restored "
                 f"(2, 2)'s step-{SHARD_TRAIN['steps']} checkpoint in "
                 f"{t['restore_s']:.1f} s, one more step: loss "
                 f"{r['loss']!r} (unsharded "
                 f"{ref['2'][SHARD_TRAIN['steps']]['loss']!r}), params "
                 f"max_abs_err {t['resumed_params'][0]:.3g}; 2-stage "
                 f"pipeline at width {SHARD_PIPE['width']}: max_abs_err "
                 f"{p['max_abs_err']:.3g} (bitwise {p['bitwise']}), "
                 f"{p['ms']:.1f} ms host")
            sp = t["sp_steps"]
            _log(f"[shard-train] {label} rank {rec['rank']}: sequence-"
                 f"parallel residual (sp=True, {SHARD_TRAIN['seq'] // 2} "
                 f"positions a rank between layers): loss "
                 f"{[m['loss'] for m in sp]} (unsharded "
                 f"{[m['loss'] for m in want[:len(sp)]]}), grad_norm "
                 f"{[round(m['grad_norm'], 6) for m in sp]}; params after "
                 f"{len(sp)} steps: max_abs_err {t['sp_params'][0]:.3g}, "
                 f"worst leaf's share past {SHARD_PARAM_ATOL:g}: "
                 f"{t['sp_params'][1]:.2e}; step host ms "
                 f"{[round(m['ms'], 1) for m in sp]}")


def _shard_train_zero(train, ref):
    """ZeRO over data 2: a (2, 2) rank's master, mu and nu hold at most
    half a (1, 2) rank's (the same model cut, the data axis added)."""
    for k in ("master", "mu", "nu"):
        a = max(t["opt_bytes"][k] for t in train[(2, 2)])
        b = min(t["opt_bytes"][k] for t in train[(1, 2)])
        _log(f"[shard-train] {k} bytes a rank: (1, 2) {b}, (2, 2) {a} "
             f"({a / b:.3f}); unsharded {ref['opt_bytes'][k]}")
        if a * 2 > b * 1.01:
            raise AssertionError(f"ZeRO did not halve {k} at data 2")


def phase_sharded(smi):
    """Phase 16: sharded serving on the one card, ranks over gloo."""
    import tempfile

    from repro_torch.runtime.serve import ServeConfig, ServeEngine

    _free_device()
    model, params = make_model(num_layers=SHARD_LAYERS)
    vocab = model.cfg.vocab_size
    reqs = _shard_requests(vocab)
    t0 = time.perf_counter()
    base, drafter = {}, None
    for name, kw in _shard_cases((2, 2)) + [("spec", None)]:
        if kw is None:  # the speculative engine replays the paged streams
            drafter = _shard_drafter(reqs, base["paged"], vocab)
            name, kw = _shard_cases((2, 2), drafter)[-1]
        eng = ServeEngine(model, params, ServeConfig(**kw))
        first, late = _shard_case_requests(name, vocab)
        for r in first:
            eng.submit(r)
        eng.step()
        eng.step()
        for r in late:
            eng.submit(r)
        base[name] = _streams(eng.run())
        if kw.get("preempt") and eng.scheduler.preempted_total < 1:
            raise AssertionError("the unsharded flood preempted nothing")
        del eng
    probe = _shard_probe(model, params, SHARD_SLOTS)
    differ = _shard_products(model, params)
    _log(f"[time] 16 unsharded engines and probe: "
         f"{time.perf_counter() - t0:.1f} s")
    totals, train = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        train_ref = _shard_train_reference(Path(tmp))
        _log(f"[time] 16 training reference (the unsharded steps): "
             f"{time.perf_counter() - t0:.1f} s")
        for shape in SHARD_MESHES:
            t0 = time.perf_counter()
            out_dir = Path(tmp) / "x".join(map(str, shape))
            out_dir.mkdir()
            with open(out_dir / "plain.json", "w") as f:
                json.dump(base["paged"], f)
            recs = _shard_world(shape, out_dir)
            label = f"mesh {shape[0]}x{shape[1]}"
            _log(f"[time] 16 {label} world: {time.perf_counter() - t0:.1f} "
                 f"s (ranks' setup {[round(r['setup_s'], 1) for r in recs]}"
                 f" s; peak {[round(r['peak_gb'], 2) for r in recs]} GB)")
            for rec in recs:
                for name, case in rec["cases"].items():
                    lc = case["launches"]
                    host, dev = case["tick_host_ms"], case["tick_dev_ms"]
                    _log(f"[shard] {label} rank {rec['rank']} "
                         f"{tuple(rec['coord'])} {name}: H {case['heads']} "
                         f"KV {case['kv_heads']} slots "
                         f"{case['slots'][0]}-{case['slots'][1] - 1}"
                         + (f" pages {case['pages']}" if "pages" in case
                            else "")
                         + f"; launches {lc}, verify rows "
                         f"{case['verify_launches']}"
                         + (f" ({case['spec']['spec_ticks']} verify ticks, "
                            f"acceptance "
                            f"{case['spec']['acceptance_rate']:.3f})"
                            if "spec" in case else "")
                         + "; kernel vs plain at the "
                         f"shard shape {case['errs']}; {len(host)} ticks, "
                         f"host ms median {statistics.median(host):.2f} max "
                         f"{max(host):.2f}, CUDA-event ms median "
                         f"{statistics.median(dev):.2f} (one {smi} shared "
                         f"by {len(recs)} ranks over {rec['backend']})"
                         + (f"; {case['preempted']} preemptions, "
                            f"{case['moved']} checkpoints moved across "
                            f"data rows" if "moved" in case else ""))
                    want = (("paged_decode_attention", "paged_prefill_"
                             "attention") if "pages" in case
                            else ("decode_attention",))
                    if any(lc[k] <= 0 for k in want) or (
                            name == "spec" and (case["spec"]["spec_ticks"] < 1
                                                or case["verify_launches"][
                                "paged_decode_attention"] <= 0)) or (
                            name == "preempt" and min(
                                case["preempted"], case["moved"]) < 1):
                        raise AssertionError(f"{label} rank {rec['rank']} "
                                             f"{name}: launches {lc}, verify "
                                             f"rows {case['verify_launches']}")
                    for k, c in lc.items():
                        totals[k] = totals.get(k, 0) + c
                    if "pages" in case and case["free_pages_by_host"]:
                        if sum(case["free_pages_by_host"]) != \
                                case["free_pages"]:
                            raise AssertionError(f"{label}: per-host pages "
                                                 f"do not sum")
            for name, _ in _shard_cases(shape, drafter):
                got = recs[0]["cases"][name]["streams"]
                if any(r["cases"][name]["streams"] != got for r in recs):
                    raise AssertionError(f"{label} {name}: the ranks' "
                                         f"streams disagree")
                case_reqs = sum(_shard_case_requests(name, vocab), [])
                n = _shard_differences(model, params, case_reqs, got,
                                       base[name], f"{label} {name}")
                _log(f"[shard] {label} {name}: streams against the "
                     f"unsharded engine's: {len(case_reqs) - n} of "
                     f"{len(case_reqs)} equal token for token")
            worst, bitwise = 0.0, True
            probes = sorted(out_dir.glob("probe_*.pt"))
            if len(probes) != shape[0]:
                raise AssertionError(f"{label}: {len(probes)} probe records "
                                     f"for {shape[0]} data rows")
            for f in probes:
                got = torch.load(f)
                lo, m = got["lo"], got["last"].shape[0]
                for key, want in (("last", probe[0]), ("decode", probe[1])):
                    w = want[lo:lo + m]
                    bitwise &= torch.equal(got[key], w)
                    worst = max(worst, float((got[key] - w).abs().max()))
            _log(f"[shard] {label} logits probe (prefill's last rows and a "
                 f"decode step, {SHARD_SLOTS} slots of "
                 f"{SHARD_PROBE_LEN} tokens) against the unsharded model: "
                 f"bitwise {bitwise}, max_abs_err {worst:.3g} (tol "
                 f"{LOGIT_TOL}); products whose bits the cut changes: "
                 f"{differ or 'none'}")
            if worst > LOGIT_TOL:
                raise AssertionError(f"{label}: sharded logits left the "
                                     f"unsharded model's")
            train[shape] = [r["train"] for r in recs]
            _shard_train_report(shape, recs, train_ref, smi)
        _shard_train_zero(train, train_ref)
    del model, params
    _free_device()
    _shard_launcher_refusal()
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--shard-rank"]:
        _shard_rank()
        from repro_torch.launch.mesh import leave_world

        leave_world()  # the rank's world, without interpreter exit
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
        return out

    device_name, smi = phase_device()
    # the two launchers that need no kernel run beside the build
    _EARLY["train"] = _spawn(TRAIN_LAUNCHER_CMD)
    _EARLY["refusal"] = _spawn(REFUSAL_CMD, REFUSAL_ENV)
    try:
        return _main(t_start, timed, device_name, smi)
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _main(t_start, timed, device_name, smi):
    timed("2 build", phase_build)
    rows = []
    for label, phase in (("3", phase_kernels), ("3p", phase_paged_kernels),
                         ("3q", phase_quant_kernels),
                         ("3c", phase_forward_kernels),
                         ("4d kernels", phase_verify_kernels),
                         ("3g", phase_grouping_kernels),
                         ("3h", phase_head_dim_kernels),
                         ("3r", phase_row_kernels)):
        rows += timed(label, phase)
    t0 = time.perf_counter()
    model, params = make_model()
    launches = phase_engine(model, params)
    paged, f32_page_bytes = phase_paged_engine(model, params)
    launches.update(paged)
    launches.update(phase_quant_engine(model, params, f32_page_bytes))
    launches.update(phase_spec_engine(model, params))
    launches["flash_attention"], _ = phase_forward_attention(model, params)
    _log(f"[time] 4-5 internlm2: {time.perf_counter() - t0:.1f} s")
    del model, params
    _free_device()
    cluster = timed("14 cluster", phase_cluster, smi)
    t0 = time.perf_counter()
    model, params = make_ssm_model()
    launches["ssd_chunk"], _ = phase_ssm(model, params)
    del model, params
    _free_device()
    _log(f"[time] 6 mamba2: {time.perf_counter() - t0:.1f} s")
    gemma = timed("7 gemma3", phase_gemma3)
    launches.update(timed("8 moe", phase_moe))
    launches.update(timed("9 zamba2", phase_zamba2))
    launches.update(timed("10 musicgen", phase_musicgen))
    launches.update(timed("11 granite", _phase_grouped, "granite-20b",
                          GRANITE_LAYERS, "granite"))
    launches.update(timed("12 qwen2.5", _phase_grouped, "qwen2.5-32b",
                          QWEN25_LAYERS, "qwen2.5"))
    # llava (G = 4) and the cluster (internlm2) run kernels whose rows an
    # earlier phase launched too: their launches add to those rows'
    for row_name, count in (*timed("13 llava", phase_llava).items(),
                            *cluster.items()):
        launches[row_name] = launches.get(row_name, 0) + count
    timed("15 train", phase_train, smi)
    # phase 16's ranks launch the engine kernels on their shards: their
    # launches add to those rows'
    for row_name, count in timed("16 sharded", phase_sharded, smi).items():
        launches[row_name] = launches.get(row_name, 0) + count
    _log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"]:
            raise AssertionError(f"{row['name']} was not launched on the "
                                 f"main path")
    if not all(gemma.values()):
        raise AssertionError(f"gemma3: a kernel was not launched: {gemma}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
