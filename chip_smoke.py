#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each printed on its own line; any failure exits non-zero:

1. card and build: the card's name and power limit, the time to build
   the CUDA kernels from ``src/repro_torch/csrc`` (and, beside them,
   the ChaCha20 and enclave-map probes of ``csrc/probes``), their
   ``-Xptxas -v`` register and spill lines (no enclave kernel, probes
   included, may spill: a spill would put plaintext in device memory),
   and each kernel's SASS instruction mix by pipe (``cuobjdump -sass``);
2. each kernel against its plain torch version on the card, bit for bit:
   kernels 1-3 (the window engine's) at the shapes of every window path
   below (DelayedFlights' 1024-record chunks and the 8-stage job's
   4096-word chunks) plus a ragged row count, per-row (mixed-epoch) keys
   and separate outbound nonces/counters; kernels 4-6 (the per-chunk
   engine's) at one 64 KB chunk (16384 words, 16384 words x 2 keys, 1024
   enclave blocks), the six enclave ops on adversarial words and ragged
   block counts.  Rows 1 and 4 are the AEAD's cipher pass, one launch
   that writes the ciphertext and the clamped MAC keys: the batched
   entry at a window's seal (8 x 16384 words), the MAC keys alone
   (B = 8) and ragged and unaligned n (1, 15, 17, 37, 5003 at B = 1 and
   3), shared and per-item keys; the single-message entry at a chunk's
   seal, ``derive_mac_keys`` and the same ragged n.  Each is timed
   beside the old composition (glue around the general-coordinate row
   and block entries, written out here, which are still checked, a
   wrapping counter included), an empty kernel over the same grid (the
   launch floor) and the pass with a block split over 4 lanes (a
   probe).  Then the device kernels of each AEAD call (seal_many,
   open_many, derive_mac_keys_many, seal, open_, derive_mac_keys),
   before and after, by torch.profiler: one ChaCha20 kernel each and no
   glue.  The CW-MAC kernels (2 and 5) write finished tags in one
   launch; their call (``mac2_batch`` with the keys as strided columns,
   ``mac2`` with scalar keys) is checked and timed at the window and
   chunk shapes and at a ragged n, n under one block and n over more
   than 8 blocks (the ticket path).  Row 3 is the window engine's enclave
   hop, one launch over the window's (B, n) words
   (``ss_enclave_map_window``): checked at B = 1, 3, 8 and n = 16384,
   4096, 1, 15, 17, 37, 5003, aligned and word-offset, the six ops,
   shared and per-item keys, with and without outbound nonces, and timed
   at DelayedFlights' and the 8-stage job's hop beside the old
   composition (glue around the rows kernel as it was, written out
   here), an empty kernel over the same grid and the interleaved-
   keystream probe (``[enclave_window]``); row 6 beside its design
   before this one and the probe (``[enclave_blocks]``); the general
   rows entry is still checked.  Each is timed beside its plain
   version and its bound: device time per call from a replayed CUDA
   graph (``ms``, ``plain_ms``) and the eager call's time, which the
   host's enqueue sets for kernels this small (``eager_ms``).  Then the
   device kernels of one enclave ``run_static_window`` hop, before and
   after (``[enclave_kernels]``: one enclave kernel, no glue), and one
   chunk's fold of the reducer before and after: device and eager ms
   and host syncs (``[reducer]``: none);
3. DelayedFlights (paper §5.2), built through the port's DSL (fluent
   form, fusion off, so its stage list equals the hand-built one), in
   enclave mode over the full 28 M-record stream in 64 KB chunks (1024
   records), one worker per stage, windows of 8 chunks: identity ->
   delay_filter_u32(15) -> carrier_delay_stats.  The stream is resident
   on the card: its one host->device copy is set-up, timed apart
   (``source_h2d_s``) and outside records/s.  The result must equal a
   numpy computation over the same records; then a short run of the
   same job (256 chunks) under torch.profiler gives the device's busy
   share and the kernels that take its time; then the job over 2 M
   records with the enclave hop and the reducer's fold each in its new
   or old form, in turns (``[attribution]``: what each change is worth);
4. the three modes (plain, encrypted, enclave) at 1 M records, each
   built by hand, through the DSL's fluent form (fused) and from the
   TOML spec ``examples/flight_delay.toml``: all equal numpy;
5. rekey_every_n=3 plus a mid-stream revocation, 2 workers: encrypted
   and enclave equal the static-key run;
6. the 8-stage scale_f32 job (2048 chunks of 4096 f32 words) in encrypted
   and enclave mode: the terminal sum is bit-equal across modes and to
   numpy's float32 chain;
7. the per-chunk oracle engine (``window_chunks=1``) on DelayedFlights:
   the three modes at 1 M records equal phase 4's window-engine results
   and numpy (with launches per chunk per kernel), enclave mode over
   4,194,304 records timed, and rekey_every_n=3 plus a mid-stream
   revocation over 64 chunks equal to the static-key run;
8. the paper's §5.1 chunk-copy experiment: a 100 MB payload on the card
   through the enclave kernel in chunks of 16 KB .. 1 MB, in and in-out,
   MB/s beside the bound; then kernels 4 (the general blocks entry and
   the cipher pass) and 5 over one 100 MB message (kernel 5's tags
   called twice: its tickets are zero again after each); then the
   cipher pass at a window, a chunk and 100 MB with its payload loads
   always before and always after the rounds (copies of the kernel
   built for timing, ``[chacha_loads]``) beside the shipped choice; then
   kernel 6 over the 100 MB as one call beside its earlier design, the
   interleaved probe and its bound;
9. kernel 7 (causal flash attention forward) against its plain torch
   version, bf16 (within a bound that scales with the values, see
   ``ref.bf16_mismatch``) and f32 (max-abs 2e-5), causal and not, at the
   serving path's prefill shape (8 requests x 4096 tokens, 32 heads of
   64), a ragged length (1000), a short one (128) and Sq < Skv; no spill
   in its D = 64 instantiations' ``-Xptxas -v`` lines; timed beside its bound (and the share of
   it), its plain version and ``scaled_dot_product_attention`` (the
   yardstick, which the port never calls) in the same run, with its
   registers, shared memory, and its exp2 count beside the
   special-function units' rate; then what sets its pace: copies of the
   kernel built without its products and exp2, and without its softmax
   as well, timed on the same inputs (``[flash_pace]``);
10. secure LM serving of llama3.2-1b at full width and depth (16 layers,
   weights drawn from a seed on the card): a client attests the serving
   enclave (``KeyDirectory(seed=7)``), 8 prompts of 4096 tokens are
   sealed and opened (MAC checked), prefilled through the engine's
   ``make_prefill_step`` (``max_seq`` 4160: the time to first token) and
   generated through ``greedy_generate`` (its prefill and 64 greedy
   decode steps); seal/open ms, prefill s and tokens/s, time to first
   token, generation s, decode ms per step and tokens/s, peak memory,
   and a profiled run's device busy share.  Then an end-to-end check at
   2 x 4096: the prefill with kernel 7 against the same prefill with the
   plain attention substituted (in this script only), on the last
   logits and on every layer's cached keys and values, and decode at
   position S against prefill(S+1); two wrong attentions put in the same
   place (no causal mask; each row's diagonal KV tile left out) must
   fail both limits, which shows the check can fail;
11. the stream engine's observability and fault tolerance.  (a)
   DelayedFlights as phase 3 builds it through the DSL, over phase 3's
   stream, with two workers a stage, ``rekey_every_n=3`` on a
   ``KeyDirectory(epoch_history=64)``, ``.retry(RetryPolicy(
   share_timeout_s=0.25))`` and ``.chaos(plan)``: a transient crash, a
   fatal crash, a stall, a tamper, a dropped verdict and a failed spare
   enrollment (a revocation of sgx_filter/w1 leaves the fatal crash
   without a survivor, so a spare is enrolled live), beside the same job
   without faults: both equal numpy and phase 3's result, every fault
   fires and leaves its audit footprint once, and the window hop (kernel
   3, re-encrypting under the fresh outbound nonces) runs once more than
   fault-free for every launch the audit log shows a fault wasted (and,
   in every (stage, round), once a share the engine dispatched plus once
   a launch wasted there);
   ``ft.*`` counters, seconds and records/s.  (b) the 8-stage job
   (phase 6's, 256 chunks) under ``ChaosPlan.seeded`` for 4 seeds,
   encrypted and enclave: bit-equal to the fault-free sum and numpy.
   (c) what observation and ft cost: DelayedFlights at 2 M records bare,
   with a ``Tracer``, with a ``PipelineMonitor`` behind a
   ``MetricsServer`` (scraped once over HTTP mid-run, the body validated
   by ``scripts/check_prometheus.py`` with per-stage series), and with a
   ``RetryPolicy`` (adaptive cutoff) and an empty ``ChaosPlan``, in
   turns A B C D D C B A: records/s of each, host syncs per window and
   dispatches per hop (equal in all four: a gate), and the backups the
   adaptive cutoff started.  (d) a traced 32-window run exported as
   Chrome JSON to ``build/phase11_trace.json``: host ms a window by span
   name beside phase 3's profiled device-busy ms a window (spans are
   host time; around a launch they measure its enqueue).

12. the secure wire.  (a) the sealed checkpoint of phase 10's
   llama3.2-1b parameters (1,235,814,400 bf16 values, ~150,860 rows of
   4,096 words, one batched seal) saved into ``build/phase12_ckpt`` and
   restored on the card, every leaf equal; a flipped byte and a dropped
   last row each raise; save and restore seconds split into host (npz,
   disk, copies) and device (the seal and open calls, by CUDA events),
   and the seal's GB/s; then the cipher pass (row 1) and the CW-MAC tags
   (row 2, one launch per 65,535 rows, counted) at that shape against
   their plain versions (a slab of rows at a time) and bounds; one seal
   of that shape from an emptied cache allocator and one warm, each
   profiled (cudaMalloc's host time beside the kernels' device time).  (b) ``pipeline_apply``
   with 4 stages of tanh(x @ w) at width 2,048 over 8 microbatches of
   4,096 tokens (32 MiB a hand-off): unsealed, sealed and sealed with
   ``rekey_every_n=2``, each bit-equal to chaining the stages; the
   largest seal and open call of each sealed run (per-item keys) bit-equal
   to the plain cipher pass and tags on its inputs; a tampered hand-off
   raises ``PipelineMACError``; ms a schedule sealed and unsealed in
   turns, seal/open calls and host syncs a tick.  (c) the
   router's keyed shuffle of 8 x 131,072 DelayedFlights records over 8
   workers by carrier, plain and sealed (one seal, one open and one
   exchange a sealed round): every record exactly once at worker
   hash(carrier) % 8 by numpy, all verdicts true, and the sealed round's
   seal and open call bit-equal to the plain cipher pass and tags on its
   inputs; ``secure_exchange`` of the mailbox equals its transpose; a
   flipped wire word fails exactly its block; MB/s plain and sealed in
   turns.
13. secure training of llama3.2-1b at full width and depth (4 x 2,048
   tokens a step, AdamW, remat "full", bf16; every number printed beside
   the card's name and power limit).  (a) at its attention shape (B 4,
   32 heads, S 2,048, D 64): kernel 7's out and its log-sum-exp (bf16
   and f32) against the plain version, the flash Function's dq/dk/dv
   against autograd through plain f32 attention; the kernel's time with
   and without the lse; the Function's backward (kernel 8) beside its
   bound, the plain block recompute it replaced, the plain attention's
   backward and SDPA's, here and at musicgen-selfattn-2.4b's training
   shape (B 3), with kernel 8's registers (no spills).  (b) one train step
   with kernel 7 ("flash") and one with the plain "chunked" attention
   from the same weights and batch: loss and global gradient norm within
   stated bf16 tolerances.  (c) ``Trainer.train()`` at full width cut
   to TRAIN_TRAINER_LAYERS layers (its sealed checkpoints are 10 bytes a
   parameter) with sealed batches
   (``examples/secure_lm_train.py``'s learnable recipe), a sealed
   checkpoint every 3 steps into ``build/phase13_ckpt`` (removed after)
   and a ``node_loss`` at step 4: restarts 1, one step replayed, and the
   final parameters equal an uninterrupted run's bit for bit (both under
   ``torch.use_deterministic_algorithms(True)``, with
   ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts); seconds a step,
   tokens/s, MFU, the device's busy share and the flash backward's share
   of a profiled step, kernel 7 launches a step, sealed ingest ms a step,
   checkpoint save and restore seconds, peak memory.
14. the other model families (every number beside the card's name and
   power limit).  (a) kernel 7 at head dims 16, 32, 96, 112 and 128 (bf16 and
   f32, with and without the lse, head-major and through the model's
   (B, S, H, D) layout; ragged, Sq < Skv, causal and not) against its
   plain version; every instantiation's registers, spills and shared
   memory; its time beside its bound, its plain version and SDPA at
   moonshot's, qwen2.5-14b's and kimi-k2's prefill shapes and at the
   smoke configs' D = 16; D = 64 again at phase 9's shape beside its
   recorded time.  (b) moonshot-v1-16b-a3b (MoE, 48 layers, 28.06 B
   parameters, 56.1 GB bf16 drawn on the card in slabs) served as phase
   10 serves llama: 4 sealed prompts of 2,048 tokens, TTFT, 32 decode
   steps, kernel 7 48 times a prefill (D = 128) and never in decode;
   the share of assignments its capacity drops; at 1 x 2,048 the
   prefill with kernel 7 against the plain attention (logits, K/V
   caches, the share of (token, layer) top-k expert sets that differ)
   and layer by layer (each layer fed the plain run's input: kernel 7
   within the limit, the two wrong attentions of phase 10 outside it);
   decode at S against prefill(S + 1) on a copy of the config whose
   capacity drops nothing, for the requests whose new token is routed
   alike in both.  (c) zamba2-1.2b (38 Mamba2 layers, 6 shared-attention
   calls, kernel 7 6 times a prefill): 8 prompts of 4,096 tokens, 64
   decode steps, the same kernel-versus-plain checks (each beside a
   prefill whose attention sums in another order), and 256
   teacher-forced decode steps after prefill(S), each against the
   forward pass over S + 256 tokens at its position, in f32, every one
   gated.  (d) xlstm-125m (6 mLSTM / sLSTM pairs, no
   kernel 7): 8 prompts of 512, 64 decode steps, the same f32
   continuation (256 steps after prefill(256)) on a copy whose sLSTM
   contracts (SLSTM_R_SCALE: its random sLSTM is chaotic),
   the port's ``chunked_gla`` on the card against its sequential oracle
   at an mLSTM layer's shape, and the sLSTM loop's share of a prefill.
15. the dry run (``repro_torch.launch.dryrun``, a step counted on meta
   tensors) beside the card.  (a) llama3.2-1b's train step at phase 13's
   4 x 2,048, remat "full" and AdamW: its dry-run record (counted FLOPs
   by op, peak estimate, t_compute) beside the same step run on the card
   (seconds, MFU, peak memory, kernel 7 launches) and phase 13's
   numbers when it ran; the FLOP terms must equal their formulas (the
   weight products 6 (N - norm gains) T at remat "none", kernel 7's
   launches x ``flash_flops``) and the peak estimate lie within
   DRYRUN_PEAK_BAND of the measured peak.  (b) qwen2.5-14b (48 layers,
   14.77 B parameters, 29.5 GB bf16 drawn on the card) served as phase
   14 serves its families: 4 sealed prompts of 2,048 tokens, 32 decode
   steps, kernel 7 48 times a prefill (D = 128) and never in decode;
   kernel 7 against the plain attention end to end and layer by layer at
   1 x S, decode at S against prefill(S + 1) layer by layer; its dry-run
   prefill and decode records at the served shape beside TTFT, decode
   ms a step and a prefill's measured peak (within DRYRUN_PEAK_BAND).
16. the other families trained on the card (FAMILY_TRAIN), seeded
   weights drawn there at full width: zamba2-1.2b at 4 x 2,048 (38 + 6
   shared), xlstm-125m at 4 x 256 (its sLSTM loop is per token),
   moonshot-v1-16b-a3b cut to 4 layers (2 when the dry run's estimate at
   4 is over MOE_TRAIN_PEAK_LIMIT) at 2 x 2,048 and musicgen-large (48
   layers, with frames) at 2 x 2,048 (1 x when the dry run says 2 do not
   fit), AdamW, remat "full".  Each beside its dry-run train record: the
   FLOP terms equal their formulas (the weight products
   ``_mm_flops_formula`` at remat "none", kernel 7's FLOPs its attention
   calls, at "none" and at the step's remat, and its launches, x
   ``flash_flops``), the peak of a step within
   DRYRUN_PEAK_BAND of the estimate; each step's loss finite and
   printed; s a step, tokens/s, MFU, busy share, kernel 7 launches a
   step; at 1 x S the gradients of a step with kernel 7 against the same
   step with the plain attention (f32 and bf16, FAMILY_GRAD_*; the MoE's
   f32 pair with the top-k choices of one pass given to the other); the
   MoE step (plain chunked attention) run twice from one state,
   bit-equal.  (b) xlstm-125m's
   ``Trainer`` with sealed data and checkpoints, a failure and a restore,
   bit-equal to an uninterrupted run.  (e) musicgen-large served at full
   width and depth as 15b serves qwen2.5-14b, with sealed frames beside
   the prompts.
17. the configs that had never run on the card.  Their plans (dry runs
   beside phases 2-15): the largest depth whose prefill and decode peak
   estimates at 4 x 2,048 + 32 are within SERVE_PEAK_LIMIT, the vlm's
   train step's depth and batch within TRAIN_PEAK_LIMIT, kimi-k2's train
   step's estimate (printed; it does not fit one card).  (a-d)
   qwen2.5-32b, granite-34b (one KV head under 48), internvl2-76b (with
   256 sealed patches a request) and kimi-k2 (384 experts, top-8) served
   at full width and their planned depths as 15b serves qwen2.5-14b (an
   MoE checked as phase 14b's, decoding at as many positions as
   DECODE_PAIRS_MIN triples need).  (e) internvl2-76b trained as phase
   16 trains its families, with 256 seeded patches a sequence.

Every pipeline run of phases 3-7 and 11, the serving runs of phases 10
and 14, the sealed and plain runs of phase 12 and the train steps and
training runs of phase 13 set the kernels' launch counts to 0 just
before each and read them just
after: it fails unless exactly the kernels of its mode's path on its
engine were launched (window engine: the cipher pass and kernels 2-3 in
enclave mode, the pass and 2 in encrypted mode; per-chunk engine: the
pass and kernels 5-6, and the pass and 5; plain mode none; serving: the
pass, 5 and 7, kernel 7 once per layer in the prefill and never in
decode (phase 14 and 15b: once per attention call, none for xLSTM;
15a's bare train step: kernel 7 alone); phase 12's
sealed runs: the cipher pass and kernel 2, its plain runs none; phase 13: kernel 7 alone in a "flash" step, nothing in
a "chunked" one, the pass and kernels 5 and 7 in the uninterrupted
training run, and kernel 2 as well in the checkpointed one; phase 16:
kernel 7 alone in a train step, nothing in xlstm-125m's, whose Trainer
run launches the pass and kernels 2 and 5).  Kernel 3
is ``ss_enclave_map_window`` there; the rows entry runs on no path.  The fault-tolerant engine (phase 11) is the window
engine's path: retries, failovers, backups and replays re-execute a
share through the same kernels, the window hop with ``nonces_out``.

Then one JSON line with every kernel's numbers (``launches`` from the
main run of its path: phase 3 for kernels 1-3, phase 7's timed run for
kernels 4-6, phase 10's serving run for kernel 7; rows 1 and 4 both
count the cipher pass, each on its own path; rows 1 and 2 also carry
phase 12's launches and their numbers at the checkpoint's shape; rows 1,
2, 4, 5 and 7 carry phase 13's launches in its recovered training run
and row 7 its training numbers, its numbers per head dim, phase 14's
serving launches and numbers, phase 15b's, phase 16's launches a train
step and its numbers, and phase 17's), and as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is available.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): 32-bit
# integer ops on the CUDA cores at the issue limit, 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz boost = 33.5 T ops/s (the data sheet
# lists no int32 rate; the kernels do integer work only).  An
# SM has 64 INT32 lanes, and nvcc sends adds, moves and shifts to its
# FP32 lanes as IMAD, so integer work can use all 128 lanes an SM issues
# to per clock: counting the INT32 lanes alone would understate the peak.
# The memory rate and the dense tensor cores' bf16 peak (kernel 7's bound)
# are the dry run's own constants, repro_torch.launch.dryrun HBM_BW and
# PEAK_FLOPS, read where a bound is computed, so the bounds and the dry
# run cannot drift apart.
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# the CUDA cores' f32 peak (data sheet): kernel 7's f32 check path
F32_FLOPS = 67e12
#: exp2 results per second of the special-function units: 16 per SM per
#: clock (4 per sub-partition), 132 SMs x 1.98 GHz — kernel 7's softmax
SFU_EXP2_PER_S = 132 * 16 * 1.98e9
#: issue slots per second of the card: 132 SMs x 4 schedulers x 1.98 GHz
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9

# int32 operations per unit of work, counted from the algorithms
CHACHA_OPS_PER_ROW = 10 * 8 * 12 + 16 + 16   # rounds, feed-forward, XOR
ENCLAVE_OPS_PER_ROW = 2 * CHACHA_OPS_PER_ROW  # decrypt + re-encrypt
CWMAC_OPS_PER_WORD = 16                       # 2 limbs x (add, mul, fold)

#: kernel 8, the flash backward: its preprocess, main and convert launches
KERNEL8 = ("ss_flash_attention_bwd_preprocess", "ss_flash_attention_bwd",
           "ss_flash_attention_bwd_convert")
#: the kernels each engine's path launches in each mode (plain mode
#: seals nothing): the window engine the batched cipher pass (kernel 1's
#: entry) and kernels 2-3, the per-chunk oracle engine the single-message
#: cipher pass (kernel 4's: the same entry at B = 1) and kernels 5-6
KERNELS = {
    "window": {
        "plain": (),
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_tags"),
        "enclave": ("ss_chacha20_cipher_pass", "ss_cwmac_tags",
                    "ss_enclave_map_window"),
    },
    "chunk": {
        "plain": (),
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags"),
        "enclave": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                    "ss_enclave_map_blocks"),
    },
    # secure LM serving: the prompts are sealed and opened with the scalar
    # AEAD (kernels 4 and 5), the prefill runs kernel 7 in every attention
    # layer; an attention-free model (xLSTM, phase 14d) runs 4 and 5 only
    "serve": {
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                      "ss_flash_attention_fwd"),
        "attention_free": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags"),
    },
    # the secure wire (phase 12): every seal and open is a batched AEAD
    # call (the cipher pass and kernel 2); the exchanges are copies
    "wire": {
        "plain": (),
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_tags"),
    },
    # secure training (phase 13): one train step launches kernel 7 twice a
    # layer under remat "full" and kernel 8's three launches once a layer
    # ("flash"; in f32 kernel 7 alone: the backward is the plain one there)
    # or nothing ("chunked"); the trainer's batches are sealed and opened
    # with the scalar AEAD (kernels 4 and 5), its checkpoints with the
    # batched one (1 and 2)
    "train_step": {
        "flash": ("ss_flash_attention_fwd",) + KERNEL8,
        "flash_f32": ("ss_flash_attention_fwd",),
        "chunked": (),
        "attention_free": (),
    },
    "train_steps": {
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                      "ss_flash_attention_fwd") + KERNEL8,
    },
    "train": {
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                      "ss_cwmac_tags", "ss_flash_attention_fwd") + KERNEL8,
        "attention_free": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                           "ss_cwmac_tags"),
    },
}
#: the run whose launch counts go into each row of the JSON line (rows
#: 1 and 4 share the cipher pass's symbol: each takes its own path's)
LAUNCHES_FROM = {
    "chacha20_cipher_pass_batch": "window", "cwmac_tags": "window",
    "enclave_map_window": "window",
    "chacha20_cipher_pass_message": "chunk", "cwmac_mac_tags": "chunk",
    "enclave_map_blocks": "chunk",
    "flash_attention_fwd": "serve",
}

#: the enclave kernels' adversarial plaintext words: NaNs, +-0,
#: subnormals, squares that underflow, +-inf, words >= 2^31
SPECIAL_WORDS = np.array([0x7FC00000, 0x7F800001, 0xFFC00001, 0x80000000,
                          0, 1, 0x00400000, 0x80000001, 0x1FFFFFFF,
                          0x20000000, 0x7F7FFFFF, 0xFF800000, 0x7F800000,
                          0x00800000, 0x80000010, 0xFFFFFFFF], np.uint32)
#: the six enclave ops, each with a constant
ENCLAVE_CASES = (("identity", 0.0), ("scale_f32", 0.1), ("relu_f32", 0.0),
                 ("square_f32", 0.0), ("threshold_mask", -0.5),
                 ("delay_filter_u32", 15.0))

RECORDS = 28_000_000        # the paper's DelayedFlights dataset
CHUNK_RECORDS = 1024        # 64 KB chunks: the paper's Fig. 4 knee
WINDOW = 8
MODES_RECORDS = 1 << 20     # phases 4 and 7: the modes, 1024 chunks
ORACLE_RECORDS = 4_194_304  # the per-chunk engine's timed run (4096 chunks)
COPY_PAYLOAD = 100 << 20    # the paper's §5.1 chunk-copy payload, bytes
COPY_CHUNKS_KB = (16, 64, 256, 1024)
SPEC_PATH = Path(__file__).resolve().parent / "examples" / "flight_delay.toml"


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def bound(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S):
    """Least ms for the work: bytes over the memory rate or operations
    over ``ops_per_s`` (int32 issue rate unless named), the larger."""
    from repro_torch.launch.dryrun import HBM_BW
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_bound_ms(mix: dict, threads: int) -> float:
    """Least device ms for ``threads`` threads of a loop-free kernel whose
    SASS mix is ``mix``: per warp, a scheduler issues one instruction a
    clock, and the ALU and FMA pipes take 16 lanes a clock each (two
    clocks per warp instruction)."""
    issued = sum(mix[k] for k in ("alu", "fma", "uniform", "mem",
                                  "control"))
    clocks = max(issued, 2 * mix["alu"], 2 * mix["fma"])
    return -(-threads // 32) * clocks / WARP_ISSUE_PER_S * 1e3


def _events_ms(torch, run, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def eager_ms(torch, fn, iters: int) -> float:
    """Mean ms per eager call of ``fn()`` (warm), by CUDA events: for a
    small kernel this is the host's enqueue time, not the device's.  Each
    call's result is dropped before the next, as a caller's would be (had
    they been kept, the allocator would grow its pool inside the timing)."""
    def calls():
        for _ in range(iters):
            fn()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _events_ms(torch, calls, iters)


def device_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Mean device ms per call of ``fn()``: ``iters`` calls captured in
    one CUDA graph and replayed, so host launch overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(torch, lambda: [graph.replay() for _ in range(reps)],
                    reps * iters)
    del graph
    return ms


def max_abs_err(a, b) -> int:
    from repro_torch.u32 import lift
    return int((lift(a) - lift(b)).abs().max().item()) if a.numel() else 0


def require_equal(what: str, a, b) -> None:
    err = max_abs_err(a, b)
    if a.shape != b.shape or err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max_abs_err={err})")


def u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


# ------------------------------------------------------------------ phases


NO_LIBRARY = ("no single PyTorch call computes this (ChaCha20, CW-MAC "
              "over 2^31-1 and the fused enclave step have no library "
              "counterpart)")


def timed_row(torch, row, run, plain, nbytes, ops, **shown):
    """Time a kernel's wrapper (``run``) beside its plain version and its
    bound, fill ``row`` with the numbers and print its phase line."""
    ms, eager = device_ms(torch, run, 50), eager_ms(torch, run, 200)
    plain_ms = device_ms(torch, plain, 2, reps=3)
    b, by = bound(nbytes, ops)
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=None, library_note=NO_LIBRARY, eager_ms=eager)
    phase("kernel", name=row["name"], bit_equal=True, ms=ms, eager_ms=eager,
          plain_ms=plain_ms, bound_ms=b, bound_by=by, **shown)
    return row


def time_tag_shapes(torch, row, cases):
    """Device and eager ms of the tag call at more shapes than the row's
    own: ``cases`` is [(label, call, plain call, words)], each checked bit
    for bit first; the numbers go into ``row["shapes"]``."""
    row["shapes"] = {}
    for label, run, plain, n_words in cases:
        require_equal(f"{row['name']} {label}", run(), plain())
        ms, eager = device_ms(torch, run, 50), eager_ms(torch, run, 200)
        b, by = bound(n_words * 4, 2 * n_words * CWMAC_OPS_PER_WORD)
        row["shapes"][label] = dict(ms=ms, eager_ms=eager, bound_ms=b)
        phase("kernel_shape", name=row["name"], shape=label, bit_equal=True,
              ms=ms, eager_ms=eager, bound_ms=b, bound_by=by)
    return row


# ------------------------------------- the cipher pass (kernels 1 and 4)


def pass_work(B: int, n: int, item_keys: bool = False):
    """(bytes, int32 operations) one cipher pass of B items of n words
    needs: the payload read and the ciphertext written, the keys, nonces
    and MAC keys; 20 rounds and the feed-forward of every block, the XOR
    of every word and the clamp of every MAC key."""
    blocks = B * (1 + (n + 15) // 16)
    nbytes = 2 * B * n * 4 + 32 * (B if item_keys else 1) + 12 * B + 16 * B
    return nbytes, blocks * (10 * 8 * 12 + 16) + B * n + 8 * B


def _clamp31(torch, w):
    return torch.clamp_max(w & 0x7FFFFFFF, 0x7FFFFFFE)


# The AEAD's cipher passes as the port composed them before the one-launch
# entry (written out here for the before/after: glue around the general
# row and block kernels).
def old_cipher_pass(torch, key, nonces, payload):
    """Batched: pad, per-row counters, nonces and keys, the rows kernel,
    clamp and the copy of the ciphertext back to (B, n)."""
    import torch.nn.functional as F
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.u32 import repeat_rows
    B, n = payload.shape
    R = (n + 15) // 16 + 1
    rows = F.pad(payload, (16, (R - 1) * 16 - n)).reshape(B * R, 16)
    ctrs = torch.arange(R, dtype=torch.int32, device=payload.device).repeat(B)
    keys = key if key.dim() == 1 else repeat_rows(key, R)
    out = chacha_ops.xor_rows(keys, repeat_rows(nonces, R), ctrs, rows)
    out = out.reshape(B, R, 16)
    return (_clamp31(torch, out[:, 0, :4]),
            out[:, 1:, :].reshape(B, -1)[:, :n].contiguous())


def old_mac_keys_many(torch, key, nonces):
    """Batched derivation: B zero rows at counter 0 through the rows
    kernel, then the clamp."""
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    B = nonces.shape[0]
    zeros = torch.zeros((B, 16), dtype=torch.int32, device=nonces.device)
    ctr0 = torch.zeros((B,), dtype=torch.int32, device=nonces.device)
    return _clamp31(torch, chacha_ops.xor_rows(key, nonces, ctr0,
                                               zeros)[:, :4])


def old_message_pass(torch, key, nonce, words):
    """One message: [zero block | padded words] through the blocks kernel
    at counter 0, the clamp and the slice."""
    import torch.nn.functional as F
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    n = words.shape[0]
    nb = (n + 15) // 16
    out = chacha_ops.xor_blocks(key, nonce, 0, F.pad(
        words, (16, nb * 16 - n)).reshape(nb + 1, 16))
    return _clamp31(torch, out[0, :4]), out[1:].reshape(-1)[:n]


def old_mac_keys(torch, key, nonce):
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    zero = torch.zeros((1, 16), dtype=torch.int32, device=nonce.device)
    return _clamp31(torch, chacha_ops.xor_blocks(key, nonce, 0,
                                                 zero)[0, :4])


#: the probe sources of ``csrc/probes``, each built into its own library
PROBE_SOURCES = ("chacha20_probes", "enclave_map_probes")


def start_probe_build():
    """nvcc on each of ``csrc/probes``' sources (the ChaCha20 probes: an
    empty kernel over the cipher pass's grid, the pass with a block over
    4 lanes; the enclave-map probes: an empty kernel over the enclave
    kernel's grid, one thread a block interleaving both keystreams, the
    kernels before the lane-pair design), all started beside the
    library's build -> {name: (process, library path)}."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT / f"probes-{build._digest()}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PROBE_SOURCES:
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(build.CSRC / "probes" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


class Probes:
    """The probes, bound with ctypes; launched on the current stream
    (inside a graph capture, the capture's)."""

    def __init__(self, torch, procs):
        import ctypes
        from repro_torch.kernels.chacha20 import ops as chacha_ops
        from repro_torch.kernels.enclave_map import ops as em_ops
        self.logs, libs = {}, {}
        for name, (proc, lib) in procs.items():
            self.logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"{name}: nvcc failed\n"
                                     f"{self.logs[name]}")
            libs[name] = ctypes.CDLL(str(lib))
        self.torch = torch
        self.lib, self.em = libs["chacha20_probes"], \
            libs["enclave_map_probes"]
        binds = (
            (self.lib.ss_probe_empty, [ctypes.c_longlong, ctypes.c_void_p]),
            (self.lib.ss_probe_cipher_pass_4lane,
             chacha_ops.PASS_KERNEL.argtypes),
            (self.em.ss_probe_enclave_empty,
             [ctypes.c_longlong, ctypes.c_void_p]),
            (self.em.ss_probe_enclave_map_window_interleaved,
             em_ops.WINDOW_KERNEL.argtypes),
            (self.em.ss_probe_enclave_map_blocks_interleaved,
             em_ops.BLOCKS_KERNEL.argtypes),
            (self.em.ss_probe_enclave_map_rows_v1, em_ops.KERNEL.argtypes),
            (self.em.ss_probe_enclave_map_blocks_v1,
             em_ops.BLOCKS_KERNEL.argtypes))
        for fn, argtypes in binds:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def _stream(self):
        return self.torch.cuda.current_stream().cuda_stream

    def _check(self, err, what):
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")

    def empty(self, blocks: int) -> None:
        """An empty kernel over the grid of a pass of ``blocks`` blocks."""
        self._check(self.lib.ss_probe_empty(blocks, self._stream()),
                    "ss_probe_empty")

    def enclave_empty(self, blocks: int) -> None:
        """An empty kernel over the enclave kernel's grid for ``blocks``
        blocks (a lane pair each)."""
        self._check(self.em.ss_probe_enclave_empty(blocks, self._stream()),
                    "ss_probe_enclave_empty")

    def pass_4lane(self, key, nonces, payload):
        """The cipher pass with 4 lanes a block -> (mac_keys, ct)."""
        torch = self.torch
        B, n = payload.shape
        mk = torch.empty((B, 4), dtype=torch.int32, device=payload.device)
        ct = torch.empty_like(payload)
        self._check(self.lib.ss_probe_cipher_pass_4lane(
            key.data_ptr(), 8 if key.dim() == 2 else 0, nonces.data_ptr(),
            payload.data_ptr(), 0, ct.data_ptr(), mk.data_ptr(), B, n,
            self._stream()), "ss_probe_cipher_pass_4lane")
        return mk, ct

    def window_interleaved(self, kin, kout, nonces, words, *, op, const=0.0,
                           nonces_out=None):
        """The window entry with one thread a block interleaving both
        keystreams (arguments of ``em_ops.enclave_map_window``)."""
        from repro_torch.kernels.enclave_map import ops as em_ops
        B, n = words.shape
        out = self.torch.empty_like(words)
        self._check(self.em.ss_probe_enclave_map_window_interleaved(
            em_ops.OP_IDS[op], kin.data_ptr(), 8 if kin.dim() == 2 else 0,
            kout.data_ptr(), 8 if kout.dim() == 2 else 0, nonces.data_ptr(),
            (nonces if nonces_out is None else nonces_out).data_ptr(),
            words.data_ptr(), out.data_ptr(), B, n,
            em_ops.const_bits(const) & 0xFFFFFFFF, _const_int(op, const),
            self._stream()), "ss_probe_enclave_map_window_interleaved")
        return out

    def _blocks(self, fn, what, kin, kout, nonce, counter0, blocks, op,
                const):
        from repro_torch.kernels.enclave_map import ops as em_ops
        out = self.torch.empty_like(blocks)
        self._check(fn(em_ops.OP_IDS[op], kin.data_ptr(), kout.data_ptr(),
                       nonce.data_ptr(), counter0 & 0xFFFFFFFF,
                       blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
                       em_ops.const_bits(const) & 0xFFFFFFFF,
                       _const_int(op, const), self._stream()), what)
        return out

    def blocks_interleaved(self, kin, kout, nonce, counter0, blocks, *, op,
                           const=0.0):
        """Kernel 6 with one thread a block interleaving both keystreams
        (arguments of ``em_ops.enclave_map``)."""
        return self._blocks(self.em.ss_probe_enclave_map_blocks_interleaved,
                            "ss_probe_enclave_map_blocks_interleaved", kin,
                            kout, nonce, counter0, blocks, op, const)

    def blocks_v1(self, kin, kout, nonce, counter0, blocks, *, op,
                  const=0.0):
        """Kernel 6 as it was before the lane-pair design."""
        return self._blocks(self.em.ss_probe_enclave_map_blocks_v1,
                            "ss_probe_enclave_map_blocks_v1", kin, kout,
                            nonce, counter0, blocks, op, const)

    def rows_v1(self, kin, kout, nonces, counters, rows, *, op, const=0.0,
                nonces_out=None, counters_out=None):
        """The rows entry as it was before the lane-pair design (arguments
        of ``em_ops.enclave_map_rows``)."""
        from repro_torch.kernels.enclave_map import ops as em_ops
        out = self.torch.empty_like(rows)
        self._check(self.em.ss_probe_enclave_map_rows_v1(
            em_ops.OP_IDS[op], kin.data_ptr(), 8 if kin.dim() == 2 else 0,
            kout.data_ptr(), 8 if kout.dim() == 2 else 0, nonces.data_ptr(),
            counters.data_ptr(),
            (nonces if nonces_out is None else nonces_out).data_ptr(),
            (counters if counters_out is None else counters_out).data_ptr(),
            rows.data_ptr(), out.data_ptr(), rows.shape[0],
            em_ops.const_bits(const) & 0xFFFFFFFF, _const_int(op, const),
            self._stream()), "ss_probe_enclave_map_rows_v1")
        return out


def _const_int(op, const):
    from repro_torch.kernels.enclave_map import ops as em_ops
    return em_ops.const_int(const) if op == "delay_filter_u32" else 0


def require_pass_equal(what, got, want):
    require_equal(f"{what} mac keys", got[0], want[0])
    if want[1] is not None:
        require_equal(f"{what} ciphertext", got[1], want[1])


def check_pass_shapes(torch, dev, rng, probes, label, shapes):
    """The batched cipher pass (and the 4-lane probe) against the plain
    version at ``shapes`` [(B, n)], shared and per-item keys, on an
    aligned payload and on one that starts a word into its buffer (the
    word-wise path), and with no payload (the MAC keys alone)."""
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import cipher_pass_ref
    from repro_torch.u32 import from_numpy
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    for B, n in shapes:
        nonces = T(u32(rng, (B, 3)))
        buf = T(u32(rng, B * n + 1))
        for key in (T(u32(rng, 8)), T(u32(rng, (B, 8)))):
            for payload in (buf[:B * n].reshape(B, n),
                            buf[1:].reshape(B, n)):
                want = cipher_pass_ref(key, nonces, payload)
                what = f"cipher pass {label} {B}x{n} keys={tuple(key.shape)}"
                require_pass_equal(what, chacha_ops.cipher_pass(
                    key, nonces, payload), want)
                require_pass_equal(f"{what} 4-lane probe",
                                   probes.pass_4lane(key, nonces, payload),
                                   want)
            require_pass_equal(f"{what} no payload", chacha_ops.cipher_pass(
                key, nonces), (want[0], None))
    phase("cipher_pass_shapes", job=label, bit_equal=True,
          shapes=",".join(f"{B}x{n}" for B, n in shapes),
          keys="shared,per_item", layouts="aligned,word_offset")


def time_cipher_pass(torch, row, run, plain, old, four_lane, probes,
                     B, n, item_keys, **shown):
    """Time one whole cipher pass (``run``) beside its plain version, its
    bound, the old composition (``old``: glue + the general-coordinate
    kernel), the 4-lane probe and an empty kernel over the same grid (the
    launch floor); fill ``row`` and print the lines."""
    nbytes, ops = pass_work(B, n, item_keys)
    timed_row(torch, row, run, plain, nbytes, ops, **shown)
    blocks = B * (1 + (n + 15) // 16)
    more = dict(
        old_ms=device_ms(torch, old, 50), old_eager_ms=eager_ms(torch, old,
                                                                200),
        empty_kernel_ms=device_ms(torch, lambda: probes.empty(blocks), 50),
        empty_kernel_eager_ms=eager_ms(torch, lambda: probes.empty(blocks),
                                       200),
        lanes4_ms=device_ms(torch, four_lane, 50))
    row.update(more)
    phase("cipher_pass", name=row["name"], blocks=blocks, ms=row["ms"],
          eager_ms=row["eager_ms"], bound_ms=row["bound_ms"], **more,
          old_over_new=more["old_ms"] / row["ms"],
          new_over_empty=row["ms"] / more["empty_kernel_ms"])
    return row


def device_kernels(torch, fn):
    """Names of the kernels one warm call of ``fn()`` runs on the card,
    from torch.profiler's device-side events.  A session can lose the
    first device event after it starts, so each opens with a marker (a
    spin kernel, synced) and is taken again, up to three times, until the
    marker shows; the marker is left out of the names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
    raise AssertionError("torch.profiler lost its marker kernel in three "
                         "sessions")


def _short(name: str) -> str:
    """A device kernel's name without its namespaces and arguments."""
    for noise in ("(anonymous namespace)::", "at::native::", "void "):
        name = name.replace(noise, "")
    return name.split("(")[0][:72]


def phase_aead_kernels(torch, dev, rng):
    """Device kernels per AEAD call, before (the old composition, written
    out above) and after, with torch.profiler at the main paths' shapes:
    a window (8 x 16384 words) for the batched calls, a 64 KB chunk for
    the scalar ones; the eager host ms of each whole call, both ways.
    Fails unless each call runs exactly one ChaCha20 kernel and nothing
    but it, its MAC's kernel and (for the opens) the verdict's compare
    and reduce, or if before and after differ in a bit."""
    from repro_torch.crypto import aead
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.u32 import from_numpy
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    B, n = WINDOW, CHUNK_RECORDS * 16
    key, nonces, words = T(u32(rng, 8)), T(u32(rng, (B, 3))), T(u32(
        rng, (B, n)))
    ct, tags = aead.seal_many(key, nonces, words)
    ct1, tag1 = aead.seal(key, nonces[0], words[0])

    def old_seal_many():
        mk, c = old_cipher_pass(torch, key, nonces, words)
        return c, cwmac_ops.mac2_batch(c, *(mk[:, i] for i in range(4)))

    def old_open_many():
        mk, p = old_cipher_pass(torch, key, nonces, ct)
        want = cwmac_ops.mac2_batch(ct, *(mk[:, i] for i in range(4)))
        return p, (want == tags).all(dim=-1)

    def old_seal():
        mk, c = old_message_pass(torch, key, nonces[0], words[0])
        return c, cwmac_ops.mac2(c, *mk)

    def old_open():
        mk, p = old_message_pass(torch, key, nonces[0], ct1)
        return p, (cwmac_ops.mac2(ct1, *mk) == tag1).all()
    calls = {   # name: (new, old, kernels besides ChaCha20 and the MAC's)
        "seal_many": (lambda: aead.seal_many(key, nonces, words),
                      old_seal_many, 0),
        "open_many": (lambda: aead.open_many(key, nonces, ct, tags),
                      old_open_many, 2),
        "derive_mac_keys_many": (
            lambda: aead.derive_mac_keys_many(key, nonces),
            lambda: old_mac_keys_many(torch, key, nonces), 0),
        "seal": (lambda: aead.seal(key, nonces[0], words[0]), old_seal, 0),
        "open_": (lambda: aead.open_(key, nonces[0], ct1, tag1), old_open,
                  2),
        "derive_mac_keys": (
            lambda: aead.derive_mac_keys(key, nonces[0]),
            lambda: tuple(old_mac_keys(torch, key, nonces[0])), 0),
    }
    out = {}
    for name, (new, old, verdict) in calls.items():
        got, was = new(), old()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        was if isinstance(was, tuple) else (was,),
                        strict=True):
            require_equal(f"{name}: new vs old composition", g, w)
        after, before = device_kernels(torch, new), device_kernels(torch, old)
        cha = sum("chacha20" in k for k in after)
        other = [k for k in after if "chacha20" not in k and "cwmac" not in k]
        out[name] = dict(kernels=len(after), kernels_before=len(before),
                         eager_ms=eager_ms(torch, new, 100),
                         eager_ms_before=eager_ms(torch, old, 100))
        phase("aead_kernels", call=name, **out[name], chacha20=cha,
              after="|".join(_short(k) for k in after),
              before="|".join(_short(k) for k in before))
        if cha != 1 or len(other) > verdict:
            raise AssertionError(f"{name}: expected one ChaCha20 kernel and "
                                 f"no glue around it, ran {after}")
    return out


# ------------------------------ the enclave hop of a window (kernel 3)


def window_work(B: int, n: int, item_keys: bool = False,
                nonces_out: bool = False):
    """(bytes, int32 operations) one enclave hop of B items of n words
    needs: the words read and written, both keys and the nonces; two
    keystreams and two XORs a block."""
    nbytes = 2 * B * n * 4 + 2 * 32 * (B if item_keys else 1) \
        + 12 * B * (2 if nonces_out else 1)
    return nbytes, B * ((n + 15) // 16) * ENCLAVE_OPS_PER_ROW


def old_window_hop(torch, kin, kout, nonces, words, *, op, const=0.0,
                   nonces_out=None, rows_fn=None):
    """The window engine's enclave hop as the port composed it before the
    one-launch entry (written out here for the before/after): pad, per-row
    nonces, counters and keys, the rows kernel (``rows_fn``, the rows
    entry by default), the copy back to (B, n)."""
    import torch.nn.functional as F
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.u32 import repeat_rows
    B, n = words.shape
    nb = (n + 15) // 16
    rows = F.pad(words, (0, nb * 16 - n)).reshape(B, nb, 16).reshape(-1, 16)
    ctrs = torch.arange(1, nb + 1, dtype=torch.int32,
                        device=words.device).repeat(B)
    kw = {} if nonces_out is None else dict(
        nonces_out=repeat_rows(nonces_out, nb))
    out = (rows_fn or em_ops.enclave_map_rows)(
        kin if kin.dim() == 1 else repeat_rows(kin, nb),
        kout if kout.dim() == 1 else repeat_rows(kout, nb),
        repeat_rows(nonces, nb), ctrs, rows, op=op, const=const, **kw)
    return out.reshape(B, -1)[:, :n].contiguous()


#: the window entry's checks: B items x n words (DelayedFlights' 16384,
#: the 8-stage job's 4096, ragged n)
WINDOW_SHAPES = [(B, n) for B in (1, 3, 8)
                 for n in (16384, 4096, 1, 15, 17, 37, 5003)]


def phase_enclave_window(torch, dev, rng, probes, rows):
    """Kernel 3's entry (``enclave_map_window``) and the interleaved probe
    against the plain version at WINDOW_SHAPES, aligned payloads and
    payloads a word into their buffer, the six ops on ciphertext that
    decrypts to adversarial words, shared and per-item keys, with and
    without outbound nonces; then timed at DelayedFlights' hop (8 x 16384,
    delay_filter_u32) and the 8-stage job's (8 x 4096, scale_f32) beside
    the old composition (with the rows kernel before the lane-pair
    design), an empty kernel over the same grid and the probe.  ``rows``:
    the rows entry's times (phase 2).  -> the kernel's row."""
    from repro_torch.kernels.chacha20.ref import cipher_pass_ref
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.kernels.enclave_map.ref import enclave_map_window_ref
    from repro_torch.u32 import from_numpy
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    checked = 0
    for B, n in WINDOW_SHAPES:
        pt = u32(rng, B * n)
        pt[1::16] = rng.integers(0, 64, len(pt[1::16]))   # delay words
        pt[:16] = SPECIAL_WORDS[:B * n]
        pt = T(pt).view(B, n)
        nonces, nout = T(u32(rng, (B, 3))), T(u32(rng, (B, 3)))
        for kin, kout in ((T(u32(rng, 8)), T(u32(rng, 8))),
                          (T(u32(rng, (B, 8))), T(u32(rng, (B, 8))))):
            # ciphertext that decrypts to pt, aligned and a word into
            # its buffer (the word-wise path)
            ct = cipher_pass_ref(kin, nonces, pt)[1].reshape(-1)
            store = torch.zeros(B * n + 1, dtype=torch.int32, device=dev)
            for off in (0, 1):
                store[off:off + B * n] = ct
                words = store[off:off + B * n].view(B, n)
                for op, c in ENCLAVE_CASES:
                    for no in (None, nout):
                        kw = dict(op=op, const=c, nonces_out=no)
                        want = enclave_map_window_ref(kin, kout, nonces,
                                                      words, **kw)
                        what = (f"enclave window {B}x{n} offset={off} "
                                f"keys={tuple(kin.shape)} {op} "
                                f"nonces_out={no is not None}")
                        require_equal(what, em_ops.enclave_map_window(
                            kin, kout, nonces, words, **kw), want)
                        require_equal(f"{what} interleaved probe",
                                      probes.window_interleaved(
                                          kin, kout, nonces, words, **kw),
                                      want)
                        checked += 1
    phase("enclave_window_shapes", bit_equal=True, cases=checked,
          shapes=",".join(f"{B}x{n}" for B, n in WINDOW_SHAPES),
          ops=len(ENCLAVE_CASES), keys="shared,per_item",
          layouts="aligned,word_offset", nonces_out="none,given")

    timed = {}
    for label, B, n, op, c in (("flights", WINDOW, CHUNK_RECORDS * 16,
                                "delay_filter_u32", 15.0),
                               ("stage8", WINDOW, 4096, "scale_f32", 1.0625)):
        kin, kout, nonces = T(u32(rng, 8)), T(u32(rng, 8)), T(u32(
            rng, (B, 3)))
        words = T(u32(rng, (B, n)))
        kw = dict(op=op, const=c)
        run = lambda: em_ops.enclave_map_window(  # noqa: E731
            kin, kout, nonces, words, **kw)
        plain = lambda: enclave_map_window_ref(  # noqa: E731
            kin, kout, nonces, words, **kw)
        old = lambda: old_window_hop(  # noqa: E731
            torch, kin, kout, nonces, words, rows_fn=probes.rows_v1, **kw)
        got = run()
        require_equal(f"enclave window {label}", got, plain())
        require_equal(f"enclave window {label} vs old composition", got,
                      old())
        blocks = B * ((n + 15) // 16)
        if label == "flights":
            row = timed_row(
                torch, dict(name="enclave_map_window", route="cuda",
                            source="src/repro_torch/csrc/enclave_map.cu",
                            replaces="src/repro/kernels/enclave_map/"
                                     "enclave_map.py:84",
                            symbol="ss_enclave_map_window",
                            max_abs_err=max_abs_err(got, plain()),
                            shape=f"the window's enclave hop: {B} x {n} "
                                  f"words, {op}, shared keys -> ({B}, {n})",
                            rows_ms=rows["ms"], rows_v1_ms=rows["v1_ms"]),
                run, plain, *window_work(B, n), blocks=blocks)
            ms, eager = row["ms"], row["eager_ms"]
        else:
            ms, eager = device_ms(torch, run, 50), eager_ms(torch, run, 200)
        more = dict(
            ms=ms, eager_ms=eager,
            bound_ms=bound(*window_work(B, n))[0],
            old_ms=device_ms(torch, old, 50),
            old_eager_ms=eager_ms(torch, old, 200),
            empty_kernel_ms=device_ms(
                torch, lambda: probes.enclave_empty(blocks), 50),
            interleaved_ms=device_ms(
                torch, lambda: probes.window_interleaved(
                    kin, kout, nonces, words, **kw), 50))
        timed[label] = more
        phase("enclave_window", hop=label, items=B, words=n, blocks=blocks,
              op=op, **more, old_over_new=more["old_ms"] / ms,
              new_over_empty=ms / more["empty_kernel_ms"])
    row["hops"] = timed
    return row


def phase_enclave_kernels(torch, dev, rng, probes):
    """The device kernels of one enclave-mode ``run_static_window`` hop
    of a DelayedFlights window (8 x 16384 words), after and before (the
    old composition, written out above, in place of the window entry),
    by torch.profiler, and the eager host ms of the whole hop both ways.
    Fails unless the hop runs exactly one enclave kernel and no pad,
    arange, repeat or copy kernel around it (besides the ChaCha20 and
    CW-MAC kernels of its MAC check and re-tag, the verdict's compare and
    reduce and the host->device copies of its keys and nonces), or if
    before and after differ in a bit."""
    from repro_torch.core import enclave
    from repro_torch.crypto.keys import StageKey
    from repro_torch.kernels.enclave_map import ops as em_ops
    key_in, key_out = (StageKey(key=u32(rng, 8).view(np.int32), stage_id=i)
                       for i in (1, 2))
    xs = [torch.from_numpy(flight_like(rng, CHUNK_RECORDS)).to(dev)
          for _ in range(WINDOW)]
    win = enclave.seal_tensors_window(key_in, range(WINDOW), xs)
    ex = enclave.EnclaveExecutor("enclave", key_in, key_out)

    def hop():
        return ex.run_static_window("delay_filter_u32", 15.0, win)

    def old_hop():
        new = em_ops.enclave_map_window
        em_ops.enclave_map_window = lambda *a, **kw: old_window_hop(
            torch, *a, rows_fn=probes.rows_v1, **kw)
        try:
            return hop()
        finally:
            em_ops.enclave_map_window = new
    (got, ok), (was, ok_was) = hop(), old_hop()
    require_equal("enclave hop words: new vs old composition", got.words,
                  was.words)
    require_equal("enclave hop tags: new vs old composition", got.tags,
                  was.tags)
    if not (bool(ok.all()) and bool(ok_was.all())):
        raise AssertionError("enclave hop: a MAC verdict failed")
    after, before = device_kernels(torch, hop), device_kernels(torch,
                                                               old_hop)
    enc = sum("enclave" in k for k in after)
    other = [k for k in after if not any(
        w in k for w in ("enclave", "chacha20", "cwmac", "Memcpy HtoD"))]
    out = dict(kernels=len(after), kernels_before=len(before),
               enclave_kernels=enc, eager_ms=eager_ms(torch, hop, 100),
               eager_ms_before=eager_ms(torch, old_hop, 100))
    phase("enclave_kernels", hop="run_static_window enclave "
          f"{WINDOW}x{CHUNK_RECORDS * 16}", **out,
          after="|".join(_short(k) for k in after),
          before="|".join(_short(k) for k in before))
    if enc != 1 or len(other) > 2:
        raise AssertionError(f"enclave hop: expected one enclave kernel and "
                             f"no glue around it, ran {after}")
    return out


def flight_like(rng, rows):
    """(rows, 16) int32-carried DelayedFlights records from ``rng``."""
    from repro_torch.data.synthetic import flight_records
    return flight_records(rows, seed=int(rng.integers(1 << 30))).view(
        np.int32)


# -------------------------------------------------- the reducer's fold


def old_carrier_fold(torch, num_carriers=20):
    """``carrier_delay_stats``' fold as the port had it before: one
    weighted ``bincount`` each for the count and the sum (each sizes its
    output from a device max: a host sync), every row's carrier."""
    from repro_torch.u32 import lift

    def fn(acc, chunk):
        carrier, delay = lift(chunk[:, 0]), lift(chunk[:, 1])
        valid = (delay > 0).to(torch.float64)
        acc["count"] = acc["count"] + torch.bincount(
            carrier, weights=valid, minlength=num_carriers)
        acc["sum"] = acc["sum"] + torch.bincount(
            carrier, weights=delay.to(torch.float64) * valid,
            minlength=num_carriers)
        return acc
    return fn


def host_syncs(torch, fn):
    """Host syncs one call of ``fn()`` makes, as CUDA's sync debug mode
    reports them -> (count, "file:line" of each)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in seen
             if "called a synchronizing" in str(w.message)]
    return len(sites), sites


def profiled_device_ms(torch, fn, calls: int) -> float:
    """Device ms per call of ``fn()`` from torch.profiler's device-side
    events (for calls that sync the host, which a CUDA graph cannot
    capture)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(r[1] for r in device_rows(prof)) / 1e3 / calls


def phase_reducer(torch, dev, rng):
    """One chunk's fold of ``carrier_delay_stats`` (1024 DelayedFlights
    records, into a state that has folded one before) after and before
    (``old_carrier_fold``): device ms, eager ms and host syncs a fold.
    Fails unless the two agree or the new fold syncs the host."""
    from repro_torch.dsl.reducers import resolve_reducer
    chunk = torch.from_numpy(flight_like(rng, CHUNK_RECORDS)).to(dev)
    fn, init = resolve_reducer("carrier_delay_stats", device=dev)
    old = old_carrier_fold(torch)

    def zeros():
        return {k: torch.zeros_like(v) for k, v in init.items()}
    got, was = fn.finish(fn(init, chunk)), old(zeros(), chunk)
    for k in ("count", "sum"):
        if not torch.equal(got[k], was[k]):
            raise AssertionError(f"reducer fold: {k} differs from the old "
                                 f"fold")
    acc, acc_old = fn(init, chunk), old(zeros(), chunk)
    syncs, sites = host_syncs(torch, lambda: fn(acc, chunk))
    out = dict(
        syncs=syncs, syncs_before=host_syncs(
            torch, lambda: old(acc_old, chunk))[0],
        device_ms=profiled_device_ms(torch, lambda: fn(acc, chunk), 20),
        device_ms_before=profiled_device_ms(
            torch, lambda: old(acc_old, chunk), 20),
        eager_ms=eager_ms(torch, lambda: fn(acc, chunk), 200),
        eager_ms_before=eager_ms(torch, lambda: old(acc_old, chunk), 200))
    phase("reducer", fold="carrier_delay_stats", records=CHUNK_RECORDS,
          **out, sync_sites=",".join(sites) or "none")
    if out["syncs"] != 0:
        raise AssertionError(f"reducer fold: {out['syncs']} host syncs a "
                             f"chunk, expected 0")
    return out


def phase_card_and_build(torch):
    global CARD
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    CARD = f'"{smi.splitlines()[0]}"'   
    t0 = time.perf_counter()
    probe_build = start_probe_build()        # beside the library's nvccs
    build.library()
    dt = time.perf_counter() - t0
    probes = Probes(torch, probe_build)
    phase("build", seconds=round(dt, 3),
          built=build.build_seconds is not None,
          with_probes_s=round(time.perf_counter() - t0, 3),
          nvcc_flags=" ".join(build.NVCC_FLAGS))
    for k in build.ptxas_kernels(build.ptxas_report()):
        phase("ptxas", kernel=k["name"], registers=k["registers"],
              spill_stores=k["spill_stores"], spill_loads=k["spill_loads"])
        print("   " + " | ".join(k["lines"]), flush=True)
        if "enclave" in k["name"] and (k["spill_stores"] != 0
                                       or k["spill_loads"] != 0):
            raise AssertionError(f"{k['name']} spills registers: plaintext "
                                 f"would reach device memory")
    mixes = build.sass_mix(build.sass_report())
    for m in mixes:
        top = sorted(m["ops"].items(), key=lambda kv: -kv[1])[:8]
        phase("sass", kernel=m["name"], alu=m["alu"], fma=m["fma"],
              uniform=m["uniform"], mem=m["mem"], control=m["control"],
              loops=m["loops"], top=",".join(f"{o}:{n}" for o, n in top))
    # each probe library also builds the library source it includes: its
    # own kernels are printed, and no enclave kernel of it may spill
    for name, log in probes.logs.items():
        for k in build.ptxas_kernels(log):
            own = any(w in k["name"] for w in ("4lane", "empty",
                                               "interleaved", "v1"))
            if own:
                phase("ptxas_probe", kernel=k["name"],
                      registers=k["registers"],
                      spill_stores=k["spill_stores"],
                      spill_loads=k["spill_loads"])
            if (name == "enclave_map_probes" or "enclave" in k["name"]) \
                    and (k["spill_stores"] != 0 or k["spill_loads"] != 0):
                raise AssertionError(f"{name}: {k['name']} spills "
                                     f"registers: plaintext would reach "
                                     f"device memory")
    return mixes, probes


def phase_kernels(torch, dev, probes):
    from repro_torch.crypto import cwmac
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import (chacha20_xor_rows_ref,
                                                  cipher_pass_ref)
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.cwmac.ref import mac_tags_ref
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.kernels.enclave_map.ref import enclave_apply_rows_ref
    from repro_torch.u32 import from_numpy, repeat_rows

    rng = np.random.default_rng(0)
    B = WINDOW
    n_blocks = CHUNK_RECORDS                 # 16 words per record
    n_words = n_blocks * 16
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    rows_out = []

    # ---- the general-coordinate rows entry (the old composition's): a
    # window's 8 x (1 + 1024) rows, ragged per-row keys, per-row keys,
    # the mac-key rows
    R = B * (n_blocks + 1)
    key = T(u32(rng, 8))
    nonces = repeat_rows(T(u32(rng, (B, 3))), n_blocks + 1)
    ctrs = torch.arange(n_blocks + 1, dtype=torch.int32,
                        device=dev).repeat(B)
    data = T(u32(rng, (R, 16)))
    require_equal("chacha20 rows shared key",
                  chacha_ops.xor_rows(key, nonces, ctrs, data),
                  chacha20_xor_rows_ref(key, nonces, ctrs, data))
    xor_rows_ms = device_ms(
        torch, lambda: chacha_ops.xor_rows(key, nonces, ctrs, data), 50)
    Rr = 1037                                # ragged, per-row keys
    args = (T(u32(rng, (Rr, 8))), T(u32(rng, (Rr, 3))), T(u32(rng, Rr)),
            T(u32(rng, (Rr, 16))))
    require_equal("chacha20 rows ragged per-row keys",
                  chacha_ops.xor_rows(*args), chacha20_xor_rows_ref(*args))
    row_keys = repeat_rows(T(u32(rng, (B, 8))), n_blocks + 1)
    require_equal("chacha20 rows per-row keys", chacha_ops.xor_rows(
        row_keys, nonces, ctrs, data), chacha20_xor_rows_ref(
        row_keys, nonces, ctrs, data))
    args = (T(u32(rng, (B, 8))), T(u32(rng, (B, 3))),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.zeros((B, 16), dtype=torch.int32, device=dev))
    require_equal("chacha20 rows mac-key rows", chacha_ops.xor_rows(*args),
                  chacha20_xor_rows_ref(*args))

    # ---- the cipher pass of a window (kernel 1's entry): seal_many's and
    # open_many's at 8 x 16384 words, the MAC keys alone at B = 8
    # (derive_mac_keys_many), ragged and unaligned n at B = 1 and 3
    key, nonces = T(u32(rng, 8)), T(u32(rng, (B, 3)))
    words = T(u32(rng, (B, n_words)))
    check_pass_shapes(torch, dev, rng, probes, "window",
                      [(B, n_words), (B, 0)] + [
                          (b, n) for b in (1, 3)
                          for n in (1, 15, 17, 37, 5003)])
    got = chacha_ops.cipher_pass(key, nonces, words)
    want = cipher_pass_ref(key, nonces, words)
    require_pass_equal("cipher pass window", got, want)
    require_pass_equal("cipher pass window vs old composition", got,
                       old_cipher_pass(torch, key, nonces, words))
    require_equal("derive_mac_keys_many vs old composition",
                  chacha_ops.cipher_pass(key, nonces)[0],
                  old_mac_keys_many(torch, key, nonces))
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    rows_out.append(time_cipher_pass(
        torch, dict(name="chacha20_cipher_pass_batch", route="cuda",
                    source="src/repro_torch/csrc/chacha20.cu",
                    replaces="src/repro/kernels/chacha20/chacha20.py:37",
                    symbol="ss_chacha20_cipher_pass", max_abs_err=err,
                    shape=f"seal_many's cipher pass: {B} x {n_words} words, "
                          f"shared key -> ct and ({B}, 4) MAC keys",
                    xor_rows_ms=xor_rows_ms),
        lambda: chacha_ops.cipher_pass(key, nonces, words),
        lambda: cipher_pass_ref(key, nonces, words),
        lambda: old_cipher_pass(torch, key, nonces, words),
        lambda: probes.pass_4lane(key, nonces, words), probes,
        B, n_words, False, xor_rows_ms=xor_rows_ms))
    derive = dict(ms=device_ms(torch, lambda: chacha_ops.cipher_pass(
        key, nonces), 50), old_ms=device_ms(
        torch, lambda: old_mac_keys_many(torch, key, nonces), 50),
        empty_kernel_ms=device_ms(torch, lambda: probes.empty(B), 50))
    rows_out[-1]["derive_mac_keys_many"] = derive
    phase("cipher_pass", name="derive_mac_keys_many", blocks=B, **derive)

    # ---- CW-MAC: mac2 of a window, 2 keys x 8 rows x 16384 words, the
    # keys as the AEAD holds them (strided columns of (B, 4) rows)
    words = T(u32(rng, (B, n_words)))
    mk = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, (B, 4)),
                         dtype=torch.int32, device=dev)
    r1, s1, r2, s2 = (mk[:, i] for i in range(4))

    def tags_case(w, k):
        cols = [k[:, i] for i in range(4)]
        return (lambda: cwmac_ops.mac2_batch(w, *cols),
                lambda: mac_tags_ref(w, k[:, 0::2], k[:, 1::2],
                                     cwmac_ops.block_words(*w.shape[::-1])))
    run, plain = tags_case(words, mk)
    got = run()
    require_equal("cwmac tags", got, plain())
    require_equal("cwmac tags vs crypto.cwmac", got, cwmac.mac2_batch(
        words, r1, s1, r2, s2))
    err = max_abs_err(got, plain())
    rows_out.append(time_tag_shapes(torch, timed_row(
        torch, dict(name="cwmac_tags", route="cuda",
                    source="src/repro_torch/csrc/cwmac.cu",
                    replaces="src/repro/kernels/cwmac/cwmac.py:59",
                    symbol="ss_cwmac_tags", max_abs_err=err,
                    shape=f"mac2_batch: 2 keys x {B} rows x {n_words} "
                          f"words -> ({B}, 2) tags, one launch"),
        run, plain, B * n_words * 4 + 4 * B * 4 + 2 * B * 4,
        2 * B * n_words * CWMAC_OPS_PER_WORD, rows=2 * B, words=n_words,
        plan=cwmac_ops.plan(n_words, B)), [
            (f"{r}x{n}", *tags_case(T(u32(rng, (r, n))), mk[:r]), r * n)
            for r, n in ((3, 5003), (3, 37), (2, 140000))]))

    # ---- the general rows entry of the enclave map (off every path; the
    # window hop's before it had its own entry): a window's 8 x 1024
    # rows, the six ops on adversarial words, ragged per-row keys with
    # separate outbound coordinates, per-row keys; beside it the rows
    # kernel as it was before the lane-pair design (a probe)
    R = B * n_blocks
    kin, kout = T(u32(rng, 8)), T(u32(rng, 8))
    nonces = repeat_rows(T(u32(rng, (B, 3))), n_blocks)
    ctrs = torch.arange(1, n_blocks + 1, dtype=torch.int32,
                        device=dev).repeat(B)
    pt = u32(rng, (R, 16))
    pt[:, 1] = rng.integers(0, 64, R)        # delay word near the threshold
    pt[: len(SPECIAL_WORDS)] = SPECIAL_WORDS
    data = T(pt)
    for op, c in ENCLAVE_CASES:
        want = enclave_apply_rows_ref(kin, kout, nonces, ctrs, data, op=op,
                                      const=c)
        require_equal(f"enclave_map rows {op}", em_ops.enclave_map_rows(
            kin, kout, nonces, ctrs, data, op=op, const=c), want)
        require_equal(f"enclave_map rows v1 probe {op}", probes.rows_v1(
            kin, kout, nonces, ctrs, data, op=op, const=c), want)
    Rr = 777                                 # ragged, mixed epochs, reseal
    args = (T(u32(rng, (Rr, 8))), T(u32(rng, (Rr, 8))),
            T(u32(rng, (Rr, 3))), T(u32(rng, Rr)), T(u32(rng, (Rr, 16))))
    kw = dict(op="scale_f32", const=-2.5, nonces_out=T(u32(rng, (Rr, 3))),
              counters_out=T(u32(rng, Rr)))
    require_equal("enclave_map rows ragged per-row keys + reseal coords",
                  em_ops.enclave_map_rows(*args, **kw),
                  enclave_apply_rows_ref(*args, **kw))
    kw = dict(op="delay_filter_u32", const=15.0)
    args = (repeat_rows(T(u32(rng, (B, 8))), n_blocks),
            repeat_rows(T(u32(rng, (B, 8))), n_blocks), nonces, ctrs, data)
    require_equal("enclave_map rows per-row keys",
                  em_ops.enclave_map_rows(*args, **kw),
                  enclave_apply_rows_ref(*args, **kw))
    rows = dict(
        ms=device_ms(torch, lambda: em_ops.enclave_map_rows(
            kin, kout, nonces, ctrs, data, **kw), 50),
        v1_ms=device_ms(torch, lambda: probes.rows_v1(
            kin, kout, nonces, ctrs, data, **kw), 50))
    phase("enclave_rows", rows=R, bit_equal=True, **rows)

    # ---- kernel 3's entry: the window engine's enclave hop, one launch
    # over the window's (B, n) words
    rows_out.append(phase_enclave_window(torch, dev, rng, probes, rows))
    phase_kernels_stage8_shapes(torch, dev, rng)
    check_pass_shapes(torch, dev, rng, probes, "stage8", [(B, 4096)])
    return rows_out


def phase_kernels_stage8_shapes(torch, dev, rng, chunk_words=4096):
    """Each kernel against its plain version at the shapes phase 6's
    8-stage scale_f32 job gives it: a window of 8 chunks of 4096 words
    (256 blocks), shared and per-row keys, separate outbound coords."""
    from repro_torch.crypto import cwmac
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import chacha20_xor_rows_ref
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.cwmac.ref import mac_tags_ref
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.kernels.enclave_map.ref import enclave_apply_rows_ref
    from repro_torch.u32 import from_numpy, repeat_rows
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    B, n_blocks = WINDOW, chunk_words // 16
    checked = []

    # seal_many/open_many of a window: B x (1 + 256) = 2056 rows
    R = B * (n_blocks + 1)
    nonces = repeat_rows(T(u32(rng, (B, 3))), n_blocks + 1)
    ctrs = torch.arange(n_blocks + 1, dtype=torch.int32,
                        device=dev).repeat(B)
    data = T(u32(rng, (R, 16)))
    for keys in (T(u32(rng, 8)),
                 repeat_rows(T(u32(rng, (B, 8))), n_blocks + 1)):
        require_equal(f"chacha20 R={R}", chacha_ops.xor_rows(
            keys, nonces, ctrs, data), chacha20_xor_rows_ref(
            keys, nonces, ctrs, data))
    checked.append(f"chacha20:{R}x16")

    # mac2 of a window: 2 keys x 8 rows x 4096 words (two whole tiles)
    words = T(u32(rng, (B, chunk_words)))
    mk = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, (B, 4)),
                         dtype=torch.int32, device=dev)
    r1, s1, r2, s2 = (mk[:, i] for i in range(4))
    require_equal(f"cwmac tags {2 * B}x{chunk_words}",
                  cwmac_ops.mac2_batch(words, r1, s1, r2, s2),
                  mac_tags_ref(words, mk[:, 0::2], mk[:, 1::2],
                               cwmac_ops.block_words(chunk_words, B)))
    require_equal(f"cwmac mac2 {2 * B}x{chunk_words}", cwmac_ops.mac2_batch(
        words, r1, s1, r2, s2), cwmac.mac2_batch(words, r1, s1, r2, s2))
    checked.append(f"cwmac:{2 * B}x{chunk_words}")

    # the enclave hop: B x 256 = 2048 rows of scale_f32
    R = B * n_blocks
    data = T(u32(rng, (R, 16)))
    nonces = repeat_rows(T(u32(rng, (B, 3))), n_blocks)
    ctrs = torch.arange(1, n_blocks + 1, dtype=torch.int32,
                        device=dev).repeat(B)
    for kin, kout, kw in [
            (T(u32(rng, 8)), T(u32(rng, 8)), {}),
            (repeat_rows(T(u32(rng, (B, 8))), n_blocks),
             repeat_rows(T(u32(rng, (B, 8))), n_blocks),
             dict(nonces_out=repeat_rows(T(u32(rng, (B, 3))), n_blocks),
                  counters_out=T(u32(rng, R))))]:
        for c in (1.0, 1.0625, 1.4375):
            require_equal(f"enclave_map scale_f32({c}) R={R}",
                          em_ops.enclave_map_rows(kin, kout, nonces, ctrs,
                                                  data, op="scale_f32",
                                                  const=c, **kw),
                          enclave_apply_rows_ref(kin, kout, nonces, ctrs,
                                                 data, op="scale_f32",
                                                 const=c, **kw))
    checked.append(f"enclave_map:{R}x16")
    phase("kernel_shapes", job="stage8", bit_equal=True,
          checked=",".join(checked))


def phase_kernels_oracle(torch, dev, rng, probes):
    """Kernels 4-6 (the per-chunk engine's) against their plain versions
    at the shapes phase 7 gives them: one 64 KB chunk of 1024 records is
    one message of 16384 words (1025 blocks with its MAC-key block) for
    the single-message cipher pass, 16384 words x 2 keys for the
    single-message MAC and 1024 blocks for the shared-key enclave map;
    plus ragged and unaligned messages, a counter that wraps (the
    general blocks entry), the six enclave ops on adversarial words, and
    ragged block counts."""
    from repro_torch.crypto import cwmac
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import (chacha20_xor_blocks_ref,
                                                  cipher_pass_ref)
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.cwmac.ref import mac_tags_ref
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.kernels.enclave_map.ref import enclave_apply_ref
    from repro_torch.u32 import from_numpy
    T = lambda a: from_numpy(a, dev)         # noqa: E731
    rows_out = []
    n_blocks = CHUNK_RECORDS                 # one 64 KB chunk
    wrap = 2 ** 32 - 3

    # ---- the general blocks entry (the old composition's): a chunk's
    # 1025 blocks at counter0 0, a counter that wraps, ragged counts
    N = n_blocks + 1
    key, nonce, data = T(u32(rng, 8)), T(u32(rng, 3)), T(u32(rng, (N, 16)))
    for c0, n in ((0, N), (wrap, N), (5, 37), (wrap, 1)):
        require_equal(f"chacha20 blocks N={n} counter0={c0}",
                      chacha_ops.xor_blocks(key, nonce, c0, data[:n]),
                      chacha20_xor_blocks_ref(key, nonce, c0, data[:n]))
    xor_blocks_ms = device_ms(
        torch, lambda: chacha_ops.xor_blocks(key, nonce, 0, data), 50)

    # ---- the cipher pass of one message (kernel 4's entry): the scalar
    # seal/open of a chunk (16384 words), derive_mac_keys (no payload),
    # ragged and unaligned messages
    buf = T(u32(rng, 16384 + 1))
    for n in (16384, 0, 1, 15, 17, 37, 5003):
        for words in (buf[:n], buf[1:n + 1]):    # aligned, a word in
            want = cipher_pass_ref(key, nonce[None], words[None])
            require_pass_equal(
                f"cipher pass message n={n} offset={words.storage_offset()}",
                chacha_ops.cipher_pass_message(key, nonce, words),
                (want[0][0], want[1][0]))
    words = buf[:16384]
    got = chacha_ops.cipher_pass_message(key, nonce, words)
    want = cipher_pass_ref(key, nonce[None], words[None])
    require_pass_equal("cipher pass message vs old composition", got,
                       old_message_pass(torch, key, nonce, words))
    require_equal("derive_mac_keys vs old composition",
                  chacha_ops.cipher_pass_message(key, nonce)[0],
                  old_mac_keys(torch, key, nonce))
    err = max(max_abs_err(got[0], want[0][0]),
              max_abs_err(got[1], want[1][0]))
    phase("cipher_pass_shapes", job="message", bit_equal=True,
          words="16384,0,1,15,17,37,5003", layouts="aligned,word_offset")
    rows_out.append(time_cipher_pass(
        torch, dict(name="chacha20_cipher_pass_message", route="cuda",
                    source="src/repro_torch/csrc/chacha20.cu",
                    replaces="src/repro/kernels/chacha20/chacha20.py:24",
                    symbol="ss_chacha20_cipher_pass", max_abs_err=err,
                    shape="seal's cipher pass: one message of 16384 words "
                          "(a 64 KB chunk) -> ct and (4,) MAC keys",
                    xor_blocks_ms=xor_blocks_ms),
        lambda: chacha_ops.cipher_pass_message(key, nonce, words),
        lambda: cipher_pass_ref(key, nonce[None], words[None]),
        lambda: old_message_pass(torch, key, nonce, words),
        lambda: probes.pass_4lane(key, nonce[None], words[None]), probes,
        1, 16384, False, xor_blocks_ms=xor_blocks_ms))
    derive = dict(ms=device_ms(torch, lambda: chacha_ops.cipher_pass_message(
        key, nonce), 50), old_ms=device_ms(
        torch, lambda: old_mac_keys(torch, key, nonce), 50))
    rows_out[-1]["derive_mac_keys"] = derive
    phase("cipher_pass", name="derive_mac_keys", blocks=1, **derive)

    # ---- CW-MAC, one message: mac2 of one chunk, 16384 words x 2 keys,
    # the keys as (4,) views
    n_words = n_blocks * 16
    words = T(u32(rng, 140000))
    mk = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, 4), dtype=torch.int32,
                         device=dev)

    def tag_case(n):
        w = words[:n]
        keys = mk.reshape(1, 4)
        return (lambda: cwmac_ops.mac2(w, *mk),
                lambda: mac_tags_ref(w.reshape(1, -1), keys[:, 0::2],
                                     keys[:, 1::2],
                                     cwmac_ops.block_words(n, 1))[0])
    for n in (n_words, 5003, 37, 1, 140000):
        run, plain = tag_case(n)
        require_equal(f"cwmac message tags n={n}", run(), plain())
        require_equal(f"cwmac message mac2 n={n}", run(),
                      cwmac.mac2(words[:n], *mk))
    run, plain = tag_case(n_words)
    err = max_abs_err(run(), plain())
    rows_out.append(time_tag_shapes(torch, timed_row(
        torch, dict(name="cwmac_mac_tags", route="cuda",
                    source="src/repro_torch/csrc/cwmac.cu",
                    replaces="src/repro/kernels/cwmac/cwmac.py:47",
                    symbol="ss_cwmac_mac_tags", max_abs_err=err,
                    shape=f"mac2: 1 message x {n_words} words x 2 keys -> "
                          f"(2,) tags, one launch"),
        run, plain, n_words * 4 + 4 * 4 + 2 * 4,
        2 * n_words * CWMAC_OPS_PER_WORD, words=n_words,
        plan=cwmac_ops.plan(n_words, 1)), [
            (f"{n}", *tag_case(n), n) for n in (5003, 37, 140000)]))

    # ---- enclave map blocks: the per-chunk enclave hop, 1024 blocks
    kin, kout = T(u32(rng, 8)), T(u32(rng, 8))
    pt = u32(rng, (n_blocks, 16))
    pt[:, 1] = rng.integers(0, 64, n_blocks)  # delay word near threshold
    pt[: len(SPECIAL_WORDS)] = SPECIAL_WORDS
    data = T(pt)
    for op, c in ENCLAVE_CASES:
        for c0, n in ((1, n_blocks), (wrap, n_blocks), (9, 37)):
            what = f"enclave_map blocks {op} N={n} counter0={c0}"
            args = (kin, kout, nonce, c0, data[:n])
            want = enclave_apply_ref(*args, op=op, const=c)
            require_equal(what, em_ops.enclave_map(*args, op=op, const=c),
                          want)
            require_equal(f"{what} interleaved probe",
                          probes.blocks_interleaved(*args, op=op, const=c),
                          want)
            require_equal(f"{what} v1 probe",
                          probes.blocks_v1(*args, op=op, const=c), want)
    kw = dict(op="delay_filter_u32", const=15.0)
    err = max_abs_err(em_ops.enclave_map(kin, kout, nonce, 1, data, **kw),
                      enclave_apply_ref(kin, kout, nonce, 1, data, **kw))
    more = dict(
        v1_ms=device_ms(torch, lambda: probes.blocks_v1(
            kin, kout, nonce, 1, data, **kw), 50),
        interleaved_ms=device_ms(torch, lambda: probes.blocks_interleaved(
            kin, kout, nonce, 1, data, **kw), 50),
        empty_kernel_ms=device_ms(
            torch, lambda: probes.enclave_empty(n_blocks), 50))
    rows_out.append(timed_row(
        torch, dict(name="enclave_map_blocks", route="cuda",
                    source="src/repro_torch/csrc/enclave_map.cu",
                    replaces="src/repro/kernels/enclave_map/"
                             "enclave_map.py:164",
                    symbol="ss_enclave_map_blocks", max_abs_err=err,
                    shape=f"N={n_blocks} blocks x 16 words, "
                          f"delay_filter_u32"),
        lambda: em_ops.enclave_map(kin, kout, nonce, 1, data, **kw),
        lambda: enclave_apply_ref(kin, kout, nonce, 1, data, **kw),
        n_blocks * 64 * 2 + 64 + 12, n_blocks * ENCLAVE_OPS_PER_ROW,
        blocks=n_blocks, enclave_ops=6, wrapped_counter0=wrap, ragged=37))
    rows_out[-1].update(more)
    phase("enclave_blocks", blocks=n_blocks, ms=rows_out[-1]["ms"],
          eager_ms=rows_out[-1]["eager_ms"],
          bound_ms=rows_out[-1]["bound_ms"], **more,
          v1_over_new=more["v1_ms"] / rows_out[-1]["ms"],
          new_over_empty=rows_out[-1]["ms"] / more["empty_kernel_ms"])
    return rows_out


def _flights_pipeline(mode, workers, dev, *, directory=None,
                      window=WINDOW):
    """DelayedFlights built by hand (the pre-DSL form)."""
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.dsl.reducers import resolve_reducer
    fn, init = resolve_reducer("carrier_delay_stats", device=dev)
    return Pipeline([
        Stage("sgx_mapper", op="identity", workers=workers),
        Stage("sgx_filter", op="delay_filter_u32", const=15,
              workers=workers),
        Stage("reducer", op="custom", reduce_fn=fn, reduce_init=init),
    ], SecureStreamConfig(mode=mode), window_chunks=window,
        directory=directory, device=dev)


def _flights_fluent(dev, workers=1):
    """DelayedFlights through the port's DSL, fluent form, as
    ``examples/flight_delay_pipeline.py`` builds it."""
    from repro_torch.dsl import stream
    return (stream()
            .map("identity", name="sgx_mapper", workers=workers, sgx=True)
            .filter("delay_filter_u32", const=15, name="sgx_filter",
                    workers=workers, sgx=True)
            .reduce("carrier_delay_stats", name="reducer")
            .window(WINDOW).device(dev))


def _signature(stages):
    return [(s.name, s.op, s.const, s.workers, s.sgx, s.fn is None,
             s.reduce_fn is None) for s in stages]


def _numpy_flights(recs: np.ndarray):
    keep = recs[:, 1] > 15
    return (np.bincount(recs[keep, 0], minlength=20).astype(np.float64),
            np.bincount(recs[keep, 0], weights=recs[keep, 1]
                        .astype(np.float64), minlength=20))


def _chunks(recs_dev, n_chunks, revoke=None):
    for i in range(n_chunks):
        if revoke is not None and i == revoke[0]:
            revoke[1]()
        yield recs_dev[i * CHUNK_RECORDS:(i + 1) * CHUNK_RECORDS]


def _check_flights(what, out, ref):
    count, total = (out["count"].cpu().numpy(), out["sum"].cpu().numpy())
    if not (np.array_equal(count, ref[0]) and np.array_equal(total, ref[1])):
        raise AssertionError(f"{what}: result differs from numpy")


def counted_run(torch, what, mode, run, engine="window"):
    """``run()`` with every kernel's launch count set to 0 just before it
    and read just after; fails unless exactly the kernels of ``mode``'s
    path on ``engine`` were launched (plain mode launches none).  ->
    (result of ``run()``, {kernel symbol: launches})."""
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    launches = build.launch_counts()
    phase("launches", run=what, engine=engine, mode=mode, **launches)
    want = set(KERNELS[engine][mode])
    ran = {k for k, v in launches.items() if v}
    if not want <= set(launches) or ran != want:
        raise AssertionError(
            f"{what}: {mode} mode on the {engine} engine should launch "
            f"exactly {sorted(want)}, launched {sorted(ran)}")
    return out, launches


def phase_delayed_flights(torch, dev, n_records):
    from repro_torch.data.synthetic import flight_records
    from repro_torch.u32 import from_numpy
    t0 = time.perf_counter()
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_records, seed=1)[:n_chunks * CHUNK_RECORDS]
    ref = _numpy_flights(recs)
    t1 = time.perf_counter()
    recs_dev = from_numpy(recs, dev)         # the stream, on the card
    torch.cuda.synchronize()
    setup, h2d = time.perf_counter() - t0, time.perf_counter() - t1
    # built through the DSL; fusion off, so the compiled stage list is
    # the hand-built 3-stage job (fused, the identity mapper would be
    # absorbed and the job would lose a hop: phase 4 runs that form)
    p = _flights_fluent(dev).fuse(False).build("enclave")
    if _signature(p.stages) != _signature(
            _flights_pipeline("enclave", 1, dev).stages):
        raise AssertionError("the DSL's stage list differs from the "
                             "hand-built DelayedFlights pipeline")
    (out, wall), launches = counted_run(
        torch, "delayed_flights", "enclave",
        _timed(torch, p, _chunks(recs_dev, n_chunks)))
    _check_flights("DelayedFlights enclave", out, ref)
    n = n_chunks * CHUNK_RECORDS
    phase("delayed_flights", built="dsl fluent, fuse(False)",
          stages_equal_hand_built=True, mode="enclave", records=n,
          chunks=n_chunks,
          chunk_bytes=CHUNK_RECORDS * 64, window_chunks=WINDOW,
          setup_s=round(setup, 3), source_h2d_s=round(h2d, 4),
          wall_s=round(wall, 3),
          records_per_s=round(n / wall, 1),
          mb_per_s=round(n * 64 / 1e6 / wall, 2), exact=True,
          delayed=int(ref[0].sum()))
    rep = p.report()
    for name, r in rep.items():
        print(f"   report {name}: {json.dumps(r)}", flush=True)
    return launches, out


#: phase 3's attribution: DelayedFlights records of each of its eight
#: runs (cut from 8 M for the script's time limit)
ATTRIBUTION_RECORDS = 2 * 1024 * 1024


def phase_attribution(torch, dev, n_records):
    """What each of the two changes to DelayedFlights' window engine is
    worth on its own: the job over ``n_records`` in four forms, the
    enclave hop as one launch or as the old composition (written out
    above, with the rows entry in place of the window entry) times the
    reducer's fold without host syncs or the old ``bincount`` fold, run
    in turns A B C D D C B A (a drift shows on both sides).  Each result
    equals numpy.  -> {form: [records/s, records/s]}"""
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.data.synthetic import flight_records
    from repro_torch.dsl.reducers import resolve_reducer
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.u32 import from_numpy
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_chunks * CHUNK_RECORDS, seed=1)
    ref = _numpy_flights(recs)
    recs_dev = from_numpy(recs, dev)
    new_hop = em_ops.enclave_map_window

    def old_hop(*a, **kw):
        return old_window_hop(torch, *a, **kw)

    def pipeline(fold):
        fn, init = resolve_reducer("carrier_delay_stats", device=dev)
        if fold == "old":
            fn = old_carrier_fold(torch)
        return Pipeline([
            Stage("sgx_mapper", op="identity"),
            Stage("sgx_filter", op="delay_filter_u32", const=15),
            Stage("reducer", op="custom", reduce_fn=fn, reduce_init=init),
        ], SecureStreamConfig(mode="enclave"), window_chunks=WINDOW,
            device=dev)
    forms = [(h, f) for h in ("old", "new") for f in ("old", "new")]
    rates = {f"hop_{h}_fold_{f}": [] for h, f in forms}
    try:
        for hop, fold in [*forms, *reversed(forms)]:
            em_ops.enclave_map_window = new_hop if hop == "new" else old_hop
            out, wall = _timed(torch, pipeline(fold),
                               _chunks(recs_dev, n_chunks))()
            _check_flights(f"attribution hop={hop} fold={fold}", out, ref)
            rates[f"hop_{hop}_fold_{fold}"].append(
                n_chunks * CHUNK_RECORDS / wall)
    finally:
        em_ops.enclave_map_window = new_hop
    phase("attribution", records=n_chunks * CHUNK_RECORDS, order="ABCDDCBA",
          **{f"{k}_records_per_s": "/".join(f"{r:.1f}" for r in v)
             for k, v in rates.items()})
    return rates


def device_rows(prof):
    """(name, device microseconds, calls) of the kernels and copies on the
    device in a torch.profiler trace.  Only device-side events count: a
    host op (``aten::mm``) also reports the device time of the kernels it
    launched, so summing every row would count that time twice.  Nor
    does a ``record_function`` range's device-side annotation count (the
    program's spans open one whenever a profiler records): its range
    spans its kernels and the idle time between them alike."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)]


def phase_profile(torch, dev, n_records):
    """Where the time of the enclave-mode job goes: a short steady run
    under torch.profiler — device busy share (kernel time over wall) and
    the kernels that take it.  -> device-busy ms a window (None when the
    trace has no device time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import flight_records
    from repro_torch.u32 import from_numpy
    n_chunks = n_records // CHUNK_RECORDS
    recs_dev = from_numpy(flight_records(n_chunks * CHUNK_RECORDS, seed=2),
                          dev)
    _flights_pipeline("enclave", 1, dev).run(_chunks(recs_dev, WINDOW * 2))
    p = _flights_pipeline("enclave", 1, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(_chunks(recs_dev, n_chunks))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / 1e6          # microseconds -> s
    if not rows:
        phase("profile", device_busy="not measured (no device time in "
              "the trace)", wall_s=round(wall, 3))
        return None
    rows.sort(key=lambda r: -r[1])
    phase("profile", records=n_chunks * CHUNK_RECORDS,
          windows=n_chunks // WINDOW, wall_s=round(wall, 4),
          device_busy_s=round(busy, 4),
          device_busy_share=round(busy / wall, 4),
          wall_per_window_ms=round(wall / (n_chunks / WINDOW) * 1e3, 3))
    for key, t, count in rows[:12]:
        print(f"   device {t / 1e3:10.3f} ms  {count:7d} calls  {key[:90]}",
              flush=True)
    return busy / (n_chunks / WINDOW) * 1e3


def _timed(torch, p, source, **kw):
    """``p.run(source, **kw)`` to its end on the card -> (out, seconds)."""
    def go():
        t0 = time.perf_counter()
        out = p.run(source, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    return go


def phase_modes(torch, dev, n_records):
    """The three modes at 1 M records, each built three ways: by hand,
    through the DSL's fluent form (fusion on: the identity mapper is
    absorbed) and from the TOML spec ``examples/flight_delay.toml`` (2
    workers per stage).  Every result equals numpy.  -> {mode: result
    of the hand-built window-engine run}."""
    from repro_torch.data.synthetic import flight_records
    from repro_torch.dsl import load_spec
    from repro_torch.u32 import from_numpy
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_records, seed=1)[:n_chunks * CHUNK_RECORDS]
    ref = _numpy_flights(recs)
    recs_dev = from_numpy(recs, dev)
    secs, results = {}, {}
    for mode in ("plain", "encrypted", "enclave"):
        forms = {"hand": _flights_pipeline(mode, 1, dev),
                 "fluent": _flights_fluent(dev).build(mode),
                 "toml": load_spec(str(SPEC_PATH)).device(dev)
                 .build(mode)}
        for form, p in forms.items():
            (out, dt), _ = counted_run(torch, f"modes_{form}", mode, _timed(
                torch, p, _chunks(recs_dev, n_chunks)))
            secs[f"{mode}_{form}"] = round(dt, 3)
            _check_flights(f"DelayedFlights {mode} ({form})", out, ref)
            if form == "hand":
                results[mode] = out
        rep = forms["fluent"].report()
        if rep["sgx_filter"].get("fused_from") != ["sgx_mapper"]:
            raise AssertionError(f"fluent form: the identity mapper was "
                                 f"not absorbed: {rep.get('fusion')}")
    phase("modes", records=n_chunks * CHUNK_RECORDS, identical=True,
          forms="hand,fluent,toml",
          **{f"{m}_s": s for m, s in secs.items()})
    return results


def phase_rekey(torch, dev, n_records):
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.data.synthetic import flight_records
    from repro_torch.u32 import from_numpy
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_records, seed=1)[:n_chunks * CHUNK_RECORDS]
    ref = _numpy_flights(recs)
    recs_dev = from_numpy(recs, dev)
    for mode in ("encrypted", "enclave"):
        (static, _), _ = counted_run(
            torch, "static_keys", mode, _timed(
                torch, _flights_pipeline(mode, 2, dev),
                _chunks(recs_dev, n_chunks)))
        p = _flights_pipeline(mode, 2, dev)
        revoke = (n_chunks // 2, lambda: p.directory.revoke(
            Pipeline.worker_id("sgx_mapper", 1)))
        (out, _), _ = counted_run(
            torch, "rekey_revocation", mode, _timed(
                torch, p, _chunks(recs_dev, n_chunks, revoke),
                rekey_every_n=3))
        _check_flights(f"{mode} static keys", static, ref)
        _check_flights(f"{mode} rekey+revocation", out, ref)
        audit = p.directory.audit.summary()
        if audit.get("rekey", 0) < 2 or audit.get("revocation") != 1:
            raise AssertionError(f"{mode}: expected rekeys and one "
                                 f"revocation, audit says {audit}")
        phase("rekey_revocation", mode=mode, chunks=n_chunks,
              rekeys=audit["rekey"], revocations=audit["revocation"],
              evictions=audit.get("eviction", 0), equal_static=True)


def phase_stage8(torch, dev, n_chunks, chunk_words=4096):
    from repro_torch.attest.directory import KeyDirectory
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.dsl.reducers import resolve_reducer
    consts = [1.0 + 0.0625 * i for i in range(8)]
    x = np.random.default_rng(7).standard_normal(
        (n_chunks, chunk_words)).astype(np.float32)
    y = x
    for c in consts:
        y = y * np.float32(c)
    want = np.cumsum(y, axis=0, dtype=np.float32)[-1]   # sequential fold
    x_dev = torch.as_tensor(x, device=dev)
    outs = {}
    for mode in ("encrypted", "enclave"):
        fn, init = resolve_reducer("sum")
        stages = [Stage(f"s{i}", op="scale_f32", const=c,
                        workers=2 if i == 2 else 1)
                  for i, c in enumerate(consts)]
        stages.append(Stage("sum", op="custom", reduce_fn=fn,
                            reduce_init=init))
        p = Pipeline(stages, SecureStreamConfig(mode=mode),
                     directory=KeyDirectory(seed=0, epoch_history=64),
                     window_chunks=WINDOW, device=dev)
        (out, dt), _ = counted_run(torch, "stage8", mode, _timed(
            torch, p, (x_dev[i] for i in range(n_chunks))))
        outs[mode] = out.cpu().numpy()
        if outs[mode].view(np.uint32).tobytes() != want.view(
                np.uint32).tobytes():
            raise AssertionError(f"8-stage {mode}: sum differs from numpy")
        phase("stage8", mode=mode, chunks=n_chunks, chunk_words=chunk_words,
              wall_s=round(dt, 3),
              mb_per_s=round(n_chunks * chunk_words * 4 / 1e6 / dt, 2),
              bit_equal_numpy=True)


def phase_oracle(torch, dev, window_results):
    """The per-chunk oracle engine (``window_chunks=1``) on DelayedFlights
    at full width: 64 KB chunks of 1024 records.  The three modes at 1 M
    records equal the window engine's results (phase 4) and numpy; then
    enclave mode over ORACLE_RECORDS, timed; then rekey_every_n=3 with a
    mid-stream revocation over 64 chunks, equal to the static-key run.
    Every run's launch gate: kernels 4-6 in enclave mode, 4 and 5 in
    encrypted mode, none in plain.  -> launches of the timed run."""
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.data.synthetic import flight_records
    from repro_torch.u32 import from_numpy
    n_chunks = MODES_RECORDS // CHUNK_RECORDS
    recs = flight_records(MODES_RECORDS, seed=1)[:n_chunks * CHUNK_RECORDS]
    recs_dev = from_numpy(recs, dev)            # phase 4's stream
    ref = _numpy_flights(recs)
    secs = {}
    for mode in ("plain", "encrypted", "enclave"):
        p = _flights_pipeline(mode, 1, dev, window=1)
        (out, dt), launches = counted_run(
            torch, "oracle_modes", mode,
            _timed(torch, p, _chunks(recs_dev, n_chunks)), engine="chunk")
        secs[f"{mode}_s"] = round(dt, 3)
        _check_flights(f"oracle {mode}", out, ref)
        if window_results is not None:
            want = window_results[mode]
            if not (torch.equal(out["count"], want["count"])
                    and torch.equal(out["sum"], want["sum"])):
                raise AssertionError(f"oracle {mode}: differs from the "
                                     f"window engine's result")
        phase("oracle_launches_per_chunk", mode=mode, **{
            k: v / n_chunks for k, v in launches.items() if v})
    phase("oracle_modes", records=n_chunks * CHUNK_RECORDS,
          equal_window_engine=window_results is not None, equal_numpy=True,
          **secs)

    n_chunks = ORACLE_RECORDS // CHUNK_RECORDS
    recs = flight_records(n_chunks * CHUNK_RECORDS, seed=1)
    recs_dev = from_numpy(recs, dev)
    p = _flights_pipeline("enclave", 1, dev, window=1)
    (out, wall), launches = counted_run(
        torch, "oracle_enclave", "enclave",
        _timed(torch, p, _chunks(recs_dev, n_chunks)), engine="chunk")
    _check_flights("oracle enclave", out, _numpy_flights(recs))
    n = n_chunks * CHUNK_RECORDS
    phase("oracle_enclave", records=n, chunks=n_chunks, wall_s=round(wall, 3),
          records_per_s=round(n / wall, 1),
          mb_per_s=round(n * 64 / 1e6 / wall, 2), exact=True,
          ms_per_chunk=round(wall / n_chunks * 1e3, 4))
    rep = p.report()
    for name in ("sgx_mapper", "sgx_filter", "reducer"):
        print(f"   report {name}: {json.dumps(rep[name])}", flush=True)

    n_chunks = 64
    ref = _numpy_flights(recs[:n_chunks * CHUNK_RECORDS])
    for mode in ("encrypted", "enclave"):
        (static, _), _ = counted_run(
            torch, "oracle_static_keys", mode, _timed(
                torch, _flights_pipeline(mode, 2, dev, window=1),
                _chunks(recs_dev, n_chunks)), engine="chunk")
        p = _flights_pipeline(mode, 2, dev, window=1)
        revoke = (n_chunks // 2, lambda: p.directory.revoke(
            Pipeline.worker_id("sgx_mapper", 1)))
        (out, _), _ = counted_run(
            torch, "oracle_rekey_revocation", mode, _timed(
                torch, p, _chunks(recs_dev, n_chunks, revoke),
                rekey_every_n=3), engine="chunk")
        _check_flights(f"oracle {mode} static keys", static, ref)
        _check_flights(f"oracle {mode} rekey+revocation", out, ref)
        audit = p.directory.audit.summary()
        if audit.get("rekey", 0) < 2 or audit.get("revocation") != 1:
            raise AssertionError(f"oracle {mode}: expected rekeys and one "
                                 f"revocation, audit says {audit}")
        phase("oracle_rekey_revocation", mode=mode, chunks=n_chunks,
              rekeys=audit["rekey"], revocations=audit["revocation"],
              evictions=audit.get("eviction", 0), equal_static=True)
    return launches


#: the cipher pass with its payload loads always before the rounds
#: ("early") or always after them ("late"), whatever the call's size:
#: edits of ``csrc/chacha20.cu``'s one-wave threshold, for timing only
_ONE_WAVE = "constexpr long long kOneWave = 132 * 1024;"
CHACHA_LOADS = {"early": "constexpr long long kOneWave = 1LL << 62;",
                "late": "constexpr long long kOneWave = 0;"}


def chacha_loads(torch, runs):
    """Build CHACHA_LOADS's variants of the ChaCha20 source (one nvcc
    each, in parallel, into the ignored build directory) and time each
    of ``runs`` ({case: (call, iterations)}) through them in place of the
    shipped cipher pass, which chooses by the call's size.
    -> {variant: {case: [device ms, device ms]}}"""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    src = (build.CSRC / "chacha20.cu").read_text()
    if src.count(_ONE_WAVE) != 1:
        raise AssertionError(f"chacha loads: {_ONE_WAVE!r} occurs "
                             f"{src.count(_ONE_WAVE)} times, not once")
    out = build.BUILD_ROOT / f"chacha-loads-{build._digest()}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, line in CHACHA_LOADS.items():
        (out / f"{name}.cu").write_text(src.replace(_ONE_WAVE, line))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    kernel = chacha_ops.PASS_KERNEL
    fns = {"shipped": kernel._fn}           # bound by the 100 MB timing
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"chacha loads {name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).ss_chacha20_cipher_pass
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        fns[name] = fn
    times = {name: {case: [] for case in runs} for name in fns}
    try:            # in turns, A B C C B A: a drift shows on both sides
        for name in [*fns, *reversed(fns)]:
            kernel._fn = fns[name]
            for case, (run, iters) in runs.items():
                times[name][case].append(device_ms(torch, run, iters))
    finally:
        kernel._fn = fns["shipped"]
    phase("chacha_loads", **{f"{v}_{c}_ms": "/".join(f"{x:.6f}" for x in t)
                             for v, d in times.items() for c, t in d.items()})
    return times


def _wall_ms(torch, fn, iters=3):
    """Mean ms of ``fn()`` to its end on the card, host launches
    included (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_chunk_copy(torch, dev, mixes, probes):
    """The paper's §5.1 chunk-copy experiment (Fig. 4): a 100 MB payload
    resident on the card crosses the enclave kernel (kernel 6, identity
    op) in chunks of 16 KB .. 1 MB, one way (in) and there and back
    (in-out, which must restore the payload), as
    ``benchmarks/bench_chunk_copy.py`` does; then kernels 4 and 5 over
    one 100 MB message each.  Every time is beside its bound; kernel 4's
    also beside the issue bound of its SASS mix (``mixes``, phase 1).
    -> {row name: extra numbers for the kernels line}."""
    from repro_torch.crypto import cwmac
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import (chacha20_xor_blocks_ref,
                                                  cipher_pass_ref)
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.enclave_map import ops as em_ops
    from repro_torch.kernels.enclave_map.ref import enclave_apply_ref
    g = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)
    total = COPY_PAYLOAD // 64
    data = words(total, 16)
    k1, k2, nonce = words(8), words(8), words(3)
    mb = COPY_PAYLOAD / 1e6
    sizes = {}
    for kb in COPY_CHUNKS_KB:
        rpc = kb * 1024 // 64
        n_chunks = total // rpc

        def push(round_trip, rpc=rpc, n_chunks=n_chunks):
            outs = []
            for c in range(n_chunks):
                blk = data[c * rpc:(c + 1) * rpc]
                out = em_ops.enclave_map(k1, k2, nonce, 1 + c * rpc, blk,
                                         op="identity")
                if round_trip:
                    out = em_ops.enclave_map(k2, k1, nonce, 1 + c * rpc,
                                             out, op="identity")
                outs.append(out)
            return outs
        outs = push(True)
        if not torch.equal(torch.cat(outs), data):
            raise AssertionError(f"chunk copy {kb} KB: in-out did not "
                                 f"restore the payload")
        last = data[(n_chunks - 1) * rpc:]
        require_equal(f"chunk copy {kb} KB, last chunk",
                      push(False)[-1], enclave_apply_ref(
                          k1, k2, nonce, 1 + (n_chunks - 1) * rpc, last,
                          op="identity"))
        del outs
        t_in = _wall_ms(torch, lambda: push(False))
        t_io = _wall_ms(torch, lambda: push(True))
        # per chunk: both keys and the nonce, read once
        b_in, by = bound(total * 128 + n_chunks * 76,
                         total * ENCLAVE_OPS_PER_ROW)
        b_io, _ = bound(2 * (total * 128 + n_chunks * 76),
                        2 * total * ENCLAVE_OPS_PER_ROW)
        sizes[f"{kb}KB"] = dict(
            chunks=n_chunks, in_ms=t_in, inout_ms=t_io,
            in_mb_per_s=mb / (t_in / 1e3), inout_mb_per_s=mb / (t_io / 1e3),
            in_bound_ms=b_in, inout_bound_ms=b_io, bound_by=by,
            inout_overhead=t_io / t_in - 1)
        phase("chunk_copy", chunk_kb=kb, **sizes[f"{kb}KB"])

    # kernels 4 and 5 over one 100 MB message each
    run = lambda: chacha_ops.xor_blocks(k1, nonce, 1, data)  # noqa: E731
    out = run()
    for off in (0, total // 2, total - 16384):
        require_equal(f"chacha20 blocks 100 MB @ {off}", out[off:off + 16384],
                      chacha20_xor_blocks_ref(k1, nonce, 1 + off,
                                              data[off:off + 16384]))
    # device time from a replayed graph: eager calls would also time the
    # allocator's fresh 100 MB outputs
    ms = device_ms(torch, run, 5, reps=3)
    b, by = bound(total * 128 + 44, total * CHACHA_OPS_PER_ROW)
    # the blocks entry at 100 MB (many waves: payload loaded after the
    # rounds): chacha20_kernel<Blocks, vec, shared key, !early>
    mix = [m for m in mixes if "chacha20_kernel" in m["name"]
           and "BlocksELb1ELb1ELb0E" in m["name"]]
    if len(mix) != 1 or mix[0]["loops"]:
        raise AssertionError(f"the blocks entry's SASS: want one loop-free "
                             f"kernel, found {[m['name'] for m in mix]}")
    mix = mix[0]
    issue = issue_bound_ms(mix, total)
    phase("kernel_100mb", name="chacha20_xor_blocks", ms=ms, bound_ms=b,
          bound_by=by, issue_bound_ms=issue, sass_alu=mix["alu"],
          sass_fma=mix["fma"], bit_equal_slices=3)
    # the same 100 MB as one message through the cipher pass (kernel 4's
    # entry): payload blocks from counter 1, as above, plus its MAC keys
    flat = data.reshape(-1)
    mk, ct = chacha_ops.cipher_pass_message(k1, nonce, flat)
    require_equal("cipher pass 100 MB mac keys", mk, cipher_pass_ref(
        k1, nonce[None])[0][0])
    for off in (0, total // 2, total - 16384):
        require_equal(f"cipher pass 100 MB @ {off}",
                      ct.reshape(-1, 16)[off:off + 16384],
                      out[off:off + 16384])
    del mk, ct
    pass_ms = device_ms(torch, lambda: chacha_ops.cipher_pass_message(
        k1, nonce, flat), 5, reps=3)
    pb, pby = bound(*pass_work(1, flat.numel()))
    phase("kernel_100mb", name="chacha20_cipher_pass_message", ms=pass_ms,
          bound_ms=pb, bound_by=pby, xor_blocks_ms=ms,
          over_xor_blocks=pass_ms / ms, bit_equal_slices=3)
    # where the payload loads go: before the rounds (calls within a wave:
    # a window's and a chunk's pass) or after them (100 MB)
    win, nonces8 = words(WINDOW, CHUNK_RECORDS * 16), words(WINDOW, 3)
    chunk = win[0]
    loads = chacha_loads(torch, {
        "window": (lambda: chacha_ops.cipher_pass(k1, nonces8, win), 50),
        "chunk": (lambda: chacha_ops.cipher_pass_message(k1, nonce, chunk),
                  50),
        "100mb": (lambda: chacha_ops.cipher_pass_message(k1, nonce, flat),
                  5)})
    k4 = dict(ms_100mb=pass_ms, bound_ms_100mb=pb, bound_by_100mb=pby,
              xor_blocks_ms_100mb=ms, xor_blocks_bound_ms_100mb=b,
              xor_blocks_issue_bound_ms_100mb=issue, loads_ms=loads)
    mk = words(4) & 0x3FFFFFFF
    run = lambda: cwmac_ops.mac2(flat, *mk)                  # noqa: E731
    for _ in range(2):             # the ticket path leaves its tickets at 0
        if not torch.equal(run(), cwmac.mac2(flat, *mk)):
            raise AssertionError("cwmac 100 MB: tag differs from the plain "
                                 "version")
    ms = device_ms(torch, run, 5, reps=3)
    b, by = bound(flat.numel() * 4 + 16 + 8,
                  2 * flat.numel() * CWMAC_OPS_PER_WORD)
    G, m, cluster = cwmac_ops.plan(flat.numel(), 1,
                                   torch.cuda.get_device_properties(
                                       dev).multi_processor_count)
    k5 = dict(ms_100mb=ms, bound_ms_100mb=b, bound_by_100mb=by)
    phase("kernel_100mb", name="cwmac_mac_tags", ms=ms, bound_ms=b,
          bound_by=by, share_of_bound=b / ms, blocks=G, groups_per_thread=m,
          cluster=cluster, tag_equal=True, calls_checked=2)
    # kernel 6 over the 100 MB payload as one call, beside its design
    # before the lane pairs and the interleaved probe
    args = (k1, k2, nonce, 1, data)
    out = em_ops.enclave_map(*args, op="identity")
    for off in (0, total // 2, total - 16384):
        require_equal(f"enclave_map blocks 100 MB @ {off}",
                      out[off:off + 16384], enclave_apply_ref(
                          k1, k2, nonce, 1 + off, data[off:off + 16384],
                          op="identity"))
    for name, fn in (("v1", probes.blocks_v1),
                     ("interleaved", probes.blocks_interleaved)):
        require_equal(f"enclave_map blocks 100 MB {name} probe",
                      fn(*args, op="identity"), out)
    del out
    b, by = bound(total * 128 + 76, total * ENCLAVE_OPS_PER_ROW)
    k6 = dict(
        ms_100mb=device_ms(torch, lambda: em_ops.enclave_map(
            *args, op="identity"), 5, reps=3),
        v1_ms_100mb=device_ms(torch, lambda: probes.blocks_v1(
            *args, op="identity"), 5, reps=3),
        interleaved_ms_100mb=device_ms(
            torch, lambda: probes.blocks_interleaved(*args, op="identity"),
            5, reps=3),
        bound_ms_100mb=b, bound_by_100mb=by)
    phase("kernel_100mb", name="enclave_map_blocks", **k6,
          share_of_bound=b / k6["ms_100mb"], bit_equal_slices=3)
    return {"chacha20_cipher_pass_message": k4, "cwmac_mac_tags": k5,
            "enclave_map_blocks": {"chunk_copy_100mb": sizes, **k6}}


# ------------------------------------------- phases 9 and 10: LM serving

#: kernel 7's checks: (B, H, Sq, Skv); the first is the serving path's
#: prefill (8 requests x 4096 tokens, llama3.2-1b's 32 heads of 64)
FLASH_SHAPES = ((8, 32, 4096, 4096), (2, 32, 1000, 1000), (2, 32, 128, 128),
                (1, 32, 100, 300))
F32_TOL = 2e-5                   # f32, max-abs (tests/test_kernels.py)
SERVE_ARCH = "llama3.2-1b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 4096, 64
SERVE_CHECK_REQUESTS = 2
#: end-to-end tolerance on f32 logits (their std is ~0.9 with these random
#: weights) of two bf16 runs of the 16-layer model: the residual stream
#: rounds to bf16 about 50 times, each up to 2^-8 of its magnitude, so
#: runs that differ in rounding drift ~2^-4; 2^-3 leaves a factor of two
SERVE_LOGIT_TOL = 0.125
#: the same two runs on every layer's cached keys and values: the largest
#: relative L2 difference of a layer's cache (bf16 drift of ~2^-7 a
#: layer, compounding over the layers before it)
SERVE_CACHE_RTOL = 0.05


def flash_pairs(B, H, Sq, Skv, causal):
    """Attended (query, key) pairs: causal (top-left) row i attends
    min(i+1, Skv) keys; each costs one exp2 in the softmax (the kernel's
    own count, which its FLOP formula for the dry run reads too)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    return flash_ops.attended_pairs(B, H, Sq, Skv, causal)


def flash_flops(B, H, Sq, Skv, D, causal):
    """FLOPs kernel 7 needs: 2*D for q.k and 2*D for p*v per attended
    (query, key) pair (``ops.flops``: the dry run's count of it)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    return flash_ops.flops(B, H, Sq, Skv, D, causal)


def _plain_bshd(torch, keep=None):
    """The plain attention in the model's (B, S, H, D) layout.  ``keep``
    (S -> (S, S) bool) replaces the causal mask: the wrong attentions of
    phase_serve_check's controls."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

    def plain(q, k, v, *, causal=True):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if keep is None:
            return attention_ref(q, k, v, causal=causal).transpose(1, 2)
        out = torch.empty_like(q)
        mask = ~keep(q.shape[2]).to(q.device)
        for b in range(q.shape[0]):
            s = q[b].float() @ k[b].float().transpose(-1, -2)
            s = (s / math.sqrt(q.shape[-1])).masked_fill_(mask, NEG_INF)
            out[b] = (torch.softmax(s, dim=-1) @ v[b].float()).to(q.dtype)
        return out.transpose(1, 2)
    return plain


#: kernel 7 with parts of its work taken out, for timing only (their
#: results are wrong on purpose): (source text, replacement, count) edits
#: of ``csrc/flash_attention.cu``.  Their times against the whole kernel's
#: say what sets its pace: the tensor cores and the special-function
#: units, the softmax's other arithmetic, or the loads alone.
_NO_MMA = ('"wgmma.mma_async.sync.aligned', '"// wgmma.mma_async.sync.aligned',
           3)
_NO_EXP2 = ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            'y = x * 0.25f;', 1)
_NO_SOFTMAX = ("  const int col2 = 2 * (lane & 3);\n",
               "  if (k0 >= 0) return make_float2(1.f, 1.f);\n"
               "  const int col2 = 2 * (lane & 3);\n", 1)
FLASH_PACE = {"no_mma_no_exp2": (_NO_MMA, _NO_EXP2),
              "loads_only": (_NO_MMA, _NO_EXP2, _NO_SOFTMAX)}


def flash_pace(torch, run, full_ms):
    """Build FLASH_PACE's variants of kernel 7 (one nvcc each, in
    parallel, into the ignored build directory), time each in place of the
    kernel on the same inputs, and print what each part of the work costs.
    -> {variant: ms}"""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    # one translation unit: the shared header (its wgmma and exp2 are the
    # edits' targets too) in place of its #include
    src = (build.CSRC / "flash_attention.cu").read_text().replace(
        '#include "flash_tma.cuh"\n',
        (build.CSRC / "flash_tma.cuh").read_text().replace("#pragma once\n",
                                                         ""))
    out = build.BUILD_ROOT / f"flash-pace-{build._digest()}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in FLASH_PACE.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise AssertionError(f"flash pace {name}: {old!r} occurs "
                                     f"{text.count(old)} times, not {count}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    times = {}
    kernel = flash_ops.KERNEL
    real = kernel._fn                       # bound by the kernel's timing
    try:
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"flash pace {name}: nvcc failed\n{log}")
            fn = ctypes.CDLL(str(out / f"{name}.so")).ss_flash_attention_fwd
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
            kernel._fn = fn
            times[name] = eager_ms(torch, run, 20)
    finally:
        kernel._fn = real
    phase("flash_pace", full_ms=full_ms, **{f"{k}_ms": v
                                            for k, v in times.items()},
          exp2_and_mma_ms=full_ms - times["no_mma_no_exp2"],
          softmax_other_ms=times["no_mma_no_exp2"] - times["loads_only"])
    return times


def flash_instantiations(report: str) -> dict:
    """Kernel 7's ptxas entries by (type, padded width), from the template
    argument in the mangled names (``flash_fwd_bf16_kernelILi128E...``):
    bf16 64 and 128, f32 16, 32, 64 and 128; any D up to 128 runs on the
    instantiation of the next width up; the wide kernel, which takes 128 <
    D <= 256, is ("wide_bf16", 256) and ("wide_f32", 256)."""
    import re
    from repro_torch.kernels import build
    out = {}
    for k in build.ptxas_kernels(report):
        m = re.search(r"flash_fwd_(bf16|f32)_kernelILi(\d+)E", k["name"])
        if m:
            out[(m.group(1), int(m.group(2)))] = k
        m = re.search(r"flash_fwd_wide_kernelI(13__nv_bfloat16|f)E",
                      k["name"])
        if m:
            out[("wide_f32" if m.group(1) == "f" else "wide_bf16", 256)] = k
    return out


def phase_flash(torch, dev):
    """Kernel 7 against its plain version on the card at FLASH_SHAPES,
    bf16 and f32, causal and not; then its time at the serving path's
    shape beside its bound, the plain version and SDPA.  -> its row."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_RTOL, attention_ref, bf16_mismatch)
    from repro_torch.launch.dryrun import PEAK_FLOPS
    D = 64                          # llama3.2-1b's head dim
    inst = flash_instantiations(build.ptxas_report())
    ptxas = {"bf16": inst[("bf16", D)], "f32": inst[("f32", D)]}
    for k in ptxas.values():        # the D = 64 kernels do not spill
        if k["spill_stores"] != 0 or k["spill_loads"] != 0:
            raise AssertionError(f"{k['name']} spills registers")
    g = torch.Generator(device=dev).manual_seed(9)

    def qkv(B, H, Sq, Skv, dtype):
        return [torch.randn((B, H, s, D), generator=g, device=dev).to(dtype)
                for s in (Sq, Skv, Skv)]
    path_err, failed = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for causal in (True, False):
            for shape in FLASH_SHAPES:
                q, k, v = qkv(*shape, dtype)
                got = flash_ops.flash_attention_bhsd(q, k, v, causal=causal)
                want = attention_ref(q, k, v, causal=causal)
                if dtype == torch.float32:
                    err = (got - want).abs().max().item()
                    ok, more = err <= F32_TOL, dict(tol=F32_TOL)
                else:
                    err, excess, row_rel = bf16_mismatch(got, want, q, k, v,
                                                         causal=causal)
                    ok = excess <= 0 and row_rel <= BF16_ROW_RTOL
                    more = dict(excess=excess, row_rel_err=row_rel,
                                row_rtol=BF16_ROW_RTOL)
                del got, want
                if shape == FLASH_SHAPES[0] and causal and name == "bfloat16":
                    path_err = dict(max_abs_err=err, **more)
                case = f"{name} causal={causal} {'x'.join(map(str, shape))}"
                phase("flash_check", dtype=name, causal=causal,
                      shape="x".join(map(str, shape)), max_abs_err=err,
                      **more, ok=ok)
                if not ok:
                    failed.append(case)
    if failed:
        raise AssertionError(f"flash attention differs from its plain "
                             f"version: {failed}")
    B, H, S, _ = FLASH_SHAPES[0]
    q, k, v = qkv(B, H, S, S, torch.bfloat16)
    run = lambda: flash_ops.flash_attention_bhsd(q, k, v)   # noqa: E731
    ms = eager_ms(torch, run, 20)
    plain_ms = eager_ms(torch, lambda: attention_ref(q, k, v), 2)
    library_ms = eager_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        is_causal=True), 20)
    flops = flash_flops(B, H, S, S, D, True)
    b, by = bound(4 * q.numel() * q.element_size(), flops, PEAK_FLOPS)
    exp2 = flash_pairs(B, H, S, S, True)
    exp2_ms = exp2 / SFU_EXP2_PER_S * 1e3
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(
        qf, kf, vf), 2)
    f32_b, f32_by = bound(4 * qf.numel() * 4, flops, F32_FLOPS)
    del qf, kf, vf
    pace = flash_pace(torch, run, ms)
    row = dict(name="flash_attention_fwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/"
                        "flash_attention.py:27",
               symbol="ss_flash_attention_fwd", **path_err, ms=ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=library_ms,
               library_call="torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True)",
               tflops=flops / ms / 1e9, share_of_bound=b / ms,
               exp2=exp2, exp2_ms=exp2_ms, pace_ms=pace,
               registers=ptxas["bf16"]["registers"],
               smem_bytes=flash_ops.smem_bytes(D),
               f32_ms=f32_ms, f32_bound_ms=f32_b,
               shape=f"B={B} H={H} S={S} D={D} bf16 causal")
    phase("kernel", name=row["name"], ms=ms, plain_ms=plain_ms,
          library_ms=library_ms, bound_ms=b, bound_by=by,
          tflops=round(row["tflops"], 1), share_of_bound=round(b / ms, 4),
          vs_library=round(ms / library_ms, 4), exp2=exp2,
          exp2_sfu_ms=exp2_ms, registers=row["registers"],
          smem_bytes=row["smem_bytes"], f32_ms=f32_ms, f32_bound_ms=f32_b,
          f32_bound_by=f32_by)
    return row


def _serve_model(torch, dev):
    from repro_torch.configs import get_model_config
    from repro_torch.models import api
    from repro_torch.models.layers import template_leaves
    cfg = get_model_config(SERVE_ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(cfg, g, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(math.prod(s.shape) for s in template_leaves(
        api.param_template(cfg)))
    if n != cfg.param_count() or n != 1_235_814_400:
        raise AssertionError(f"llama3.2-1b has {n} parameters")
    return cfg, params, g, init_s


def phase_serve(torch, dev):
    """Secure serving of llama3.2-1b at full width and depth (phase 10).
    -> the serving run's launch counts."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.serve import secure
    from repro_torch.serve.engine import (greedy_generate, make_decode_step,
                                          make_prefill_step)
    from repro_torch.kernels import build
    cfg, params, g, init_s = _serve_model(torch, dev)
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig(
        "serve", SERVE_PROMPT, SERVE_REQUESTS, "decode"))
    t0 = time.perf_counter()
    _, key, server_m = secure.attested_session(cfg.arch_id)
    attest_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=g, device=dev, dtype=torch.int32)
    max_seq = SERVE_PROMPT + SERVE_NEW
    prefill = make_prefill_step(run_cfg, max_seq=max_seq)
    # warm-up off the counted run: the kernels' first launches, cuBLAS
    # handles, the allocator's pools
    secure.open_prompts(key, secure.seal_prompts(key, prompts, counter=1))
    greedy_generate(run_cfg, params, prompts[:, :256], steps=2, max_seq=257)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = {}

    def serve():
        t0 = time.perf_counter()
        sealed = secure.seal_prompts(key, prompts)
        torch.cuda.synchronize()
        t["seal"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        opened = secure.open_prompts(key, sealed)        # syncs on the MAC
        torch.cuda.synchronize()
        t["open"] = time.perf_counter() - t0
        if not torch.equal(opened, prompts):
            raise AssertionError("opened prompts differ from the sent ones")
        t["after_open"] = build.launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": opened})[0]   # frees its cache
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None].cpu()
        t["prefill"] = time.perf_counter() - t0
        t["after_prefill"] = build.launch_counts()
        t0 = time.perf_counter()
        gen = greedy_generate(run_cfg, params, opened, steps=SERVE_NEW + 1,
                              max_seq=max_seq).cpu()
        t["generate"] = time.perf_counter() - t0
        return first, gen, logits
    (first, gen, logits), launches = counted_run(
        torch, "secure_serve", "encrypted", serve, engine="serve")
    flash = "ss_flash_attention_fwd"
    in_prefill = t["after_prefill"][flash] - t["after_open"][flash]
    in_generate = {k: launches[k] - t["after_prefill"][k] for k in launches}
    if in_prefill != cfg.num_layers or in_generate != {
            k: cfg.num_layers if k == flash else 0 for k in launches}:
        raise AssertionError(
            f"kernel 7: {in_prefill} launches in the prefill step (want one "
            f"per layer, {cfg.num_layers}); greedy_generate launched "
            f"{in_generate} (want kernel 7 once per layer of its prefill, "
            f"none in decode)")
    if not (bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            SERVE_REQUESTS, cfg.vocab_size) and tuple(gen.shape) == (
            SERVE_REQUESTS, SERVE_NEW + 1) and torch.equal(gen[:, :1], first)
            and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise AssertionError("serving produced malformed logits or tokens")
    # greedy_generate's decode time: its whole time less one prefill (the
    # prefill step's own time, of the same prompts just before)
    decode_s = t["generate"] - t["prefill"]
    peak = torch.cuda.max_memory_allocated()
    tokens = SERVE_REQUESTS * SERVE_PROMPT
    phase("serve", arch=SERVE_ARCH, layers=cfg.num_layers,
          params=cfg.param_count(), requests=SERVE_REQUESTS,
          prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, init_params_s=init_s,
          attest_s=attest_s, measurement=server_m.hex()[:16],
          seal_ms=t["seal"] * 1e3, open_ms=t["open"] * 1e3, mac_ok=True,
          prefill_s=t["prefill"], prefill_tokens_per_s=tokens / t["prefill"],
          ttft_ms=(t["open"] + t["prefill"]) * 1e3,
          generate_s=t["generate"],
          decode_ms_per_step=decode_s / SERVE_NEW * 1e3,
          decode_tokens_per_s=SERVE_REQUESTS * SERVE_NEW / decode_s,
          peak_memory_gb=peak / 1e9, flash_launches_prefill=in_prefill)
    print(f"   generated req0: {gen[0, :12].tolist()} ...", flush=True)
    phase_serve_profile(torch, cfg, params, prompts, prefill,
                        make_decode_step(run_cfg))
    phase_serve_check(torch, cfg, params, prompts[:SERVE_CHECK_REQUESTS])
    return launches


def phase_serve_profile(torch, cfg, params, prompts, prefill_step, decode,
                        steps=16, extra=None):
    """Device busy share of one prefill at the serving shape and of
    ``steps`` decode steps after it (the engine's steps), each under its
    own torch.profiler window of the device's activity alone (as
    :func:`_busy_share`; with the host's ops traced too, a window took
    ~0.65 ms a kernel to process on the H100 host, ~0.2 ms without), and
    the kernels that take the device's time in each.  -> {part: device
    busy share, or None}"""
    from torch.profiler import ProfilerActivity, profile
    state, shares = {}, {}

    def prefill():
        logits, state["cache"] = prefill_step(params, {"tokens": prompts,
                                                       **(extra or {})})
        state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    def decode_steps():
        for pos in range(prompts.shape[1], prompts.shape[1] + steps):
            state["tok"], _, state["cache"] = decode(
                params, state["tok"], pos, state["cache"])
    for part, fn in (("prefill", prefill), ("decode", decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(device_rows(prof), key=lambda r: -r[1])
        if not rows:
            phase("serve_profile", arch=cfg.arch_id, part=part,
                  device_busy="not measured (no device time in the trace)",
                  wall_s=round(wall, 4))
            shares[part] = None
            continue
        busy = sum(r[1] for r in rows) / 1e6
        shares[part] = busy / wall
        phase("serve_profile", arch=cfg.arch_id, part=part,
              steps=steps if part == "decode" else 1, wall_s=round(wall, 4),
              device_busy_s=round(busy, 4),
              device_busy_share=round(busy / wall, 4),
              kernels=sum(r[2] for r in rows))
        for key, t_us, count in rows[:10]:
            print(f"   device {t_us / 1e3:10.3f} ms  {count:7d} calls  "
                  f"{key[:90]}", flush=True)
    return shares


def phase_serve_check(torch, cfg, params, prompts):
    """End-to-end on the card at 2 x 4096: prefill with kernel 7 against
    the same prefill with the plain attention put in its place (in this
    script only: the library is untouched), on the last logits and on
    every layer's cached keys and values; decode at position S against
    prefill(S+1)'s last position.  Two wrong attentions put in the same
    place must fail both limits: no causal mask, and each row's diagonal
    KV tile of 64 keys left out (rows of the first tile keep theirs), as
    a kernel that skips its last KV tile would compute."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api
    S = prompts.shape[1]

    def no_diagonal_tile(n):
        i = torch.arange(n)[:, None]
        j = torch.arange(n)[None, :]
        return (j <= i) & ((j < i // 64 * 64) | (i < 64))
    attentions = {
        "plain": _plain_bshd(torch),
        "control_no_causal_mask": _plain_bshd(
            torch, lambda n: torch.ones((n, n), dtype=torch.bool)),
        "control_no_diagonal_tile": _plain_bshd(torch, no_diagonal_tile),
    }
    logits_k, cache_k = api.prefill(cfg, params, {"tokens": prompts},
                                    max_seq=S + 1)
    kernel = flash_ops.flash_attention
    gaps, logits_r = {}, None
    try:
        for name, attention in attentions.items():
            flash_ops.flash_attention = attention
            logits, cache = api.prefill(cfg, params, {"tokens": prompts},
                                        max_seq=S + 1)
            cache_rel = max(
                ((cache_k["attn"][t][i] - cache["attn"][t][i]).float().norm()
                 / cache["attn"][t][i].float().norm()).item()
                for t in ("k", "v") for i in range(cfg.num_layers))
            gaps[name] = ((logits_k - logits).abs().max().item(), cache_rel)
            logits_r = logits if name == "plain" else logits_r
            del logits, cache
    finally:
        flash_ops.flash_attention = kernel
    err, cache_err = gaps["plain"]
    top2 = logits_r.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > SERVE_LOGIT_TOL
    same = logits_k.argmax(-1) == logits_r.argmax(-1)
    tok = logits_k.argmax(-1).to(torch.int32)[:, None]
    logits_d, _ = api.decode_step(cfg, params, tok, S, cache_k)
    logits_p, _ = api.prefill(cfg, params, {"tokens": torch.cat(
        [prompts, tok], dim=1)})
    err_d = (logits_d - logits_p).abs().max().item()
    controls = {name: dict(logits_max_abs=g[0], cache_rel_l2=g[1])
                for name, g in gaps.items() if name != "plain"}
    phase("serve_check", requests=prompts.shape[0], prompt=S,
          logits_std=logits_r.std().item(), kernel_vs_plain_max_abs=err,
          kernel_vs_plain_cache_rel_l2=cache_err,
          decode_vs_prefill_max_abs=err_d, tol=SERVE_LOGIT_TOL,
          cache_rtol=SERVE_CACHE_RTOL, **controls,
          decisive_first_tokens=int(decisive.sum()),
          first_tokens_equal=bool(same.all()))
    if not (err <= SERVE_LOGIT_TOL and err_d <= SERVE_LOGIT_TOL
            and cache_err <= SERVE_CACHE_RTOL
            and bool(same[decisive].all())):
        raise AssertionError("serving end-to-end check failed")
    for name, c in controls.items():
        if c["logits_max_abs"] <= SERVE_LOGIT_TOL \
                or c["cache_rel_l2"] <= SERVE_CACHE_RTOL:
            raise AssertionError(f"serving check: the wrong attention {name} "
                                 f"passes a limit ({c}), so the check could "
                                 f"not fail a wrong kernel 7")


# ------------------------------------------------------------------ phase 11

#: phase 11a: DelayedFlights as phase 3 builds it, with two workers a
#: stage, ``rekey_every_n=3`` and one fault of each kind.  Addresses are
#: (stage, round, worker) of the fault-tolerant engine's rounds (16 chunks
#: a round with two live workers, 8 with one).  Every crash fires after
#: its share ran, so each fault costs exactly one more launch of the
#: window hop than the fault-free run.  Revoking sgx_filter/w1 at chunk
#: FT_REVOKE_CHUNK leaves the fatal crash of its w0 without a survivor:
#: the engine enrolls a spare live, and the plan's enrollment failure
#: hits that admission.
FT_WORKERS = 2
FT_REKEY = 3
FT_REVOKE_CHUNK = 2048
FT_SHARE_TIMEOUT_S = 0.25             # pinned: injected stalls exceed it
#: phase 11b: seeds of ChaosPlan.seeded over the 8-stage job
FT_STAGE8_SEEDS = (0, 1, 2, 3)
FT_STAGE8_CHUNKS = 256
#: phase 11c: DelayedFlights records of each form's run, and the chunk at
#: which form C scrapes its metrics endpoint, mid-run (cut from 8 M
#: records for the script's time limit)
OBS_RECORDS = 2 * 1024 * 1024
OBS_SCRAPE_CHUNK = OBS_RECORDS // CHUNK_RECORDS // 2
#: phase 11d: the traced run's windows (as phase 3's profiled run)
TRACE_WINDOWS = 32
TRACE_PATH = Path(__file__).resolve().parent / "build" / \
    "phase11_trace.json"


def ft_plan():
    """Phase 11a's plan: a transient crash, a fatal crash, a stall, a
    tamper, a dropped verdict and a failed spare enrollment."""
    from repro_torch.ft import ChaosPlan, FaultSpec
    return ChaosPlan(faults=[
        FaultSpec("crash", stage="sgx_mapper", round=3, worker=1,
                  when="after"),
        FaultSpec("stall", stage="sgx_mapper", round=40, worker=0,
                  seconds=0.8),
        FaultSpec("tamper", stage="sgx_filter", round=7, worker=0, rows=2),
        FaultSpec("drop_verdict", stage="sgx_mapper", round=90, worker=1),
        FaultSpec("crash", stage="sgx_filter", round=400, worker=0,
                  when="after", fatal=True),
        FaultSpec("enroll_fail"),
    ])


def check_footprint(what, plan, dump):
    """Every fired fault's audit footprint exactly once, as
    ``tests/test_chaos.py`` holds the reference to it; raises
    otherwise.  -> the launches the faults wasted, read from the audit
    log: a share that ran and whose result was lost to a crash (every
    crash of these plans fires after its share ran), the slow original
    of a share a backup replaced, and one launch a replay.  A failover
    off a worker that is already dead wastes none."""
    from collections import Counter
    if plan.pending():
        raise AssertionError(f"{what}: faults never fired: "
                             f"{plan.pending()}")
    fired = {}
    for kind, stage, rnd, w in plan.events:
        fired.setdefault(kind, []).append((stage, rnd, w))

    def failed(reason, stage, rnd, w):
        return [e for e in dump if e["kind"] == "worker_failed"
                and e.get("reason") == reason and e.get("stage") == stage
                and e.get("round") == rnd
                and e.get("worker") == f"{stage}/w{w}"]

    for stage, rnd, w in fired.get("crash", []):
        follow = [e for e in dump
                  if e["kind"] in ("share_retried", "share_failover")
                  and e.get("stage") == stage and e.get("round") == rnd]
        if len(failed("crash", stage, rnd, w)) != 1 or not follow:
            raise AssertionError(f"{what}: crash at {(stage, rnd, w)} "
                                 f"not audited once with its recovery")
    for stage, rnd, w in fired.get("stall", []):
        if len(failed("stall", stage, rnd, w)) != 1:
            raise AssertionError(f"{what}: stall at {(stage, rnd, w)} "
                                 f"not audited once")
    for reason, kind in (("mac_failure", "tamper"),
                         ("verdict_dropped", "drop_verdict")):
        want = Counter((s, r) for s, r, _ in fired.get(kind, []))
        got = Counter((e["stage"], e["round"]) for e in dump
                      if e["kind"] == "window_replayed"
                      and e.get("reason") == reason)
        if got != want:
            raise AssertionError(f"{what}: {kind} replays {dict(got)} != "
                                 f"fired {dict(want)}")
    if "enroll_fail" in fired:
        rejected = [e for e in dump if e["kind"] == "quote_rejected"
                    and "chaos" in str(e.get("reason"))]
        if len(rejected) != len(fired["enroll_fail"]):
            raise AssertionError(f"{what}: enrollment failures not "
                                 f"audited once")
    return len(_wasting(dump))


def _wasting(dump):
    """The audit events of launches a fault wasted (see
    :func:`check_footprint`)."""
    return [e for e in dump
            if (e["kind"] == "worker_failed" and e["reason"] == "crash")
            or (e["kind"] == "share_failover" and e["reason"] == "backup")
            or e["kind"] == "window_replayed"]


def unexplained_rounds(ft, dump):
    """The (stage, round)s of a fault-tolerant run (``ft``: its
    FTContext) whose executions are not one a share dispatched plus one a
    launch the audit log shows a fault wasted there, each with its counts
    and the audit's events of that round."""
    from collections import Counter
    wasted = Counter((e["stage"], e["round"]) for e in _wasting(dump))
    return [dict(stage=at[0], round=at[1], shares=ft.shares[at],
                 executions=ft.executions[at], wasted_in_audit=wasted[at],
                 events=[e["kind"] for e in dump if e.get("stage") == at[0]
                         and e.get("round") == at[1]])
            for at in sorted(set(ft.executions) | set(wasted))
            if ft.executions[at] != ft.shares[at] + wasted[at]]


def ft_counters():
    from repro_torch.obs.metrics import REGISTRY
    return {name: int(REGISTRY.counter(f"ft.{name}").value)
            for name in ("retries", "failovers", "backups", "replays",
                         "worker_failures", "enroll_failures")}


def phase_ft_flights(torch, dev, n_records, faultfree_ref=None):
    """Phase 11a: DelayedFlights under chaos over phase 3's stream (see
    ``ft_plan``), beside the same job and stream without faults.  Both
    equal numpy (and phase 3's result when it ran); every fault fired
    and left its audit footprint once; the launch gate admits the cipher
    pass and kernels 2 and 3 only; the window hop ran once more than in
    the fault-free run for every launch the audit log shows a fault
    wasted (``check_footprint``), once an execution the engine counted,
    and in every (stage, round) once a share it dispatched plus once a
    wasted launch of that round (:func:`unexplained_rounds`)."""
    from repro_torch.attest.directory import KeyDirectory
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.data.synthetic import flight_records
    from repro_torch.ft import RetryPolicy
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.u32 import from_numpy
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_records, seed=1)[:n_chunks * CHUNK_RECORDS]
    ref = _numpy_flights(recs)
    recs_dev = from_numpy(recs, dev)
    n = n_chunks * CHUNK_RECORDS
    runs = {}
    for form in ("fault_free", "chaos"):
        sb = _flights_fluent(dev, workers=FT_WORKERS).fuse(False) \
            .directory(KeyDirectory(seed=0, epoch_history=64))
        plan = None
        if form == "chaos":
            plan = ft_plan()
            sb = sb.retry(RetryPolicy(share_timeout_s=FT_SHARE_TIMEOUT_S)) \
                .chaos(plan)
        p = sb.build("enclave")
        revoke = (FT_REVOKE_CHUNK, lambda p=p: p.directory.revoke(
            Pipeline.worker_id("sgx_filter", 1)))
        REGISTRY.reset(prefix="ft.")
        (out, wall), launches = counted_run(
            torch, f"ft_flights_{form}", "enclave", _timed(
                torch, p, _chunks(recs_dev, n_chunks, revoke),
                rekey_every_n=FT_REKEY))
        _check_flights(f"ft DelayedFlights {form}", out, ref)
        if faultfree_ref is not None and not (
                torch.equal(out["count"], faultfree_ref["count"])
                and torch.equal(out["sum"], faultfree_ref["sum"])):
            raise AssertionError(f"ft DelayedFlights {form}: differs from "
                                 f"phase 3's result")
        runs[form] = (p, plan, wall, launches, ft_counters())
    p, plan, wall, launches, counters = runs["chaos"]
    dump = p.directory.audit.dump()
    reexec = check_footprint("ft DelayedFlights", plan, dump)
    free_hops = runs["fault_free"][3]["ss_enclave_map_window"]
    hops = launches["ss_enclave_map_window"]
    ft = p._last_ft
    shares, execs = sum(ft.shares.values()), sum(ft.executions.values())
    unexplained = unexplained_rounds(ft, dump)
    if hops - free_hops != reexec or hops != execs or unexplained:
        raise AssertionError(
            f"ft DelayedFlights: {hops} window-hop launches against "
            f"{free_hops} fault-free, the audit shows {reexec} "
            f"re-executions that cost a launch; the engine counted "
            f"{shares} shares and {execs} executions; the (stage, round)s "
            f"whose executions are not its shares plus its wasted "
            f"launches: {unexplained[:20]}")
    filt = next(s for s in p.stages if s.name == "sgx_filter")
    if filt.workers != 3 or not p.directory.is_admitted("sgx_filter/w2"):
        raise AssertionError("ft DelayedFlights: no spare was enrolled "
                             "for sgx_filter")
    free_wall = runs["fault_free"][2]
    audit = p.directory.audit.summary()
    phase("ft_flights", mode="enclave", records=n, chunks=n_chunks,
          workers=FT_WORKERS, rekey_every_n=FT_REKEY,
          share_timeout_s=FT_SHARE_TIMEOUT_S, faults=len(plan.faults),
          fired=len(plan.events), pending=len(plan.pending()),
          equal_numpy=True, equal_phase3=faultfree_ref is not None,
          footprint_once=True, wall_s=round(wall, 3),
          records_per_s=round(n / wall, 1),
          faultfree_wall_s=round(free_wall, 3),
          faultfree_records_per_s=round(n / free_wall, 1),
          hop_launches=hops, faultfree_hop_launches=free_hops,
          shares=shares, executions=execs,
          reexecutions=reexec, spare="sgx_filter/w2",
          rekeys=audit.get("rekey", 0),
          **{f"ft_{k}": v for k, v in counters.items()})
    print(f"   events {plan.events}", flush=True)
    return launches


def phase_ft_stage8(torch, dev, n_chunks=FT_STAGE8_CHUNKS,
                    chunk_words=4096):
    """Phase 11b: the 8-stage scale_f32 job (phase 6's) under
    ``ChaosPlan.seeded`` for a few seeds, encrypted and enclave: each
    terminal sum bit-equal to the fault-free run's and numpy's."""
    from repro_torch.attest.directory import KeyDirectory
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.dsl.reducers import resolve_reducer
    from repro_torch.ft import ChaosPlan, RetryPolicy
    consts = [1.0 + 0.0625 * i for i in range(8)]
    topology = [(f"s{i}", 2 if i == 2 else 1) for i in range(8)]
    x = np.random.default_rng(7).standard_normal(
        (n_chunks, chunk_words)).astype(np.float32)
    y = x
    for c in consts:
        y = y * np.float32(c)
    want = np.cumsum(y, axis=0, dtype=np.float32)[-1].view(np.uint32)
    x_dev = torch.as_tensor(x, device=dev)

    def pipeline(mode, **kw):
        fn, init = resolve_reducer("sum")
        stages = [Stage(f"s{i}", op="scale_f32", const=c,
                        workers=2 if i == 2 else 1)
                  for i, c in enumerate(consts)]
        stages.append(Stage("sum", op="custom", reduce_fn=fn,
                            reduce_init=init))
        return Pipeline(stages, SecureStreamConfig(mode=mode),
                        directory=KeyDirectory(seed=0, epoch_history=64),
                        window_chunks=WINDOW, device=dev, **kw)

    for mode in ("encrypted", "enclave"):
        (free, _), _ = counted_run(torch, "ft_stage8_fault_free", mode,
                                   _timed(torch, pipeline(mode), (
                                       x_dev[i] for i in range(n_chunks))))
        free = free.cpu().numpy().view(np.uint32)
        if not np.array_equal(free, want):
            raise AssertionError(f"ft 8-stage {mode}: the fault-free sum "
                                 f"differs from numpy")
        fired = []
        for seed in FT_STAGE8_SEEDS:
            plan = ChaosPlan.seeded(seed, topology, rounds=3, n_faults=3)
            p = pipeline(mode, retry=RetryPolicy(
                share_timeout_s=FT_SHARE_TIMEOUT_S), chaos=plan)
            (out, _), _ = counted_run(
                torch, f"ft_stage8_seed{seed}", mode, _timed(
                    torch, p, (x_dev[i] for i in range(n_chunks))))
            if not np.array_equal(out.cpu().numpy().view(np.uint32), free):
                raise AssertionError(f"ft 8-stage {mode} seed {seed}: the "
                                     f"sum differs from the fault-free run")
            check_footprint(f"ft 8-stage {mode} seed {seed}", plan,
                            p.directory.audit.dump())
            fired.append("+".join(e[0] for e in plan.events))
        phase("ft_stage8", mode=mode, chunks=n_chunks,
              seeds=",".join(map(str, FT_STAGE8_SEEDS)),
              faults="/".join(fired), bit_equal_fault_free=True,
              bit_equal_numpy=True)


def phase_observation_cost(torch, dev, n_records):
    """Phase 11c: DelayedFlights (phase 3's job, one worker a stage) in
    four forms run in turns A B C D D C B A: A bare, B with a Tracer, C
    with a PipelineMonitor behind a MetricsServer (scraped once over
    HTTP mid-run; the body passes ``scripts/check_prometheus.py``'s
    ``validate`` with a per-stage series), D with a RetryPolicy (its
    adaptive cutoff) and an empty ChaosPlan.  Each equals numpy; host
    syncs per window and dispatches per hop are equal across the forms.
    -> {form: [records/s, ...]}"""
    import importlib.util
    import urllib.request
    from repro_torch.core import pipeline as pipeline_mod
    from repro_torch.data.synthetic import flight_records
    from repro_torch.ft import ChaosPlan, RetryPolicy
    from repro_torch.obs import (PipelineMonitor, REGISTRY, Tracer,
                                 serve_metrics)
    from repro_torch.u32 import from_numpy
    spec = importlib.util.spec_from_file_location(
        "check_prometheus", Path(__file__).resolve().parent / "scripts"
        / "check_prometheus.py")
    check_prometheus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_prometheus)
    n_chunks = n_records // CHUNK_RECORDS
    recs = flight_records(n_chunks * CHUNK_RECORDS, seed=1)
    ref = _numpy_flights(recs)
    recs_dev = from_numpy(recs, dev)
    n = n_chunks * CHUNK_RECORDS
    forms = ("bare", "tracer", "monitor", "ft")
    rates = {f: [] for f in forms}
    shape = {}
    scraped = {}
    for form in [*forms, *reversed(forms)]:
        kw, server, policy = {}, None, None
        if form == "tracer":
            kw["tracer"] = Tracer()
        elif form == "monitor":
            kw["monitor"] = PipelineMonitor()
            server = serve_metrics(0, monitor=kw["monitor"])
        elif form == "ft":
            policy = RetryPolicy()
            kw.update(retry=policy, chaos=ChaosPlan())
        p = _flights_pipeline("enclave", 1, dev)

        def source():
            for i, c in enumerate(_chunks(recs_dev, n_chunks)):
                if server is not None and i == OBS_SCRAPE_CHUNK:
                    body = urllib.request.urlopen(
                        server.url + "/metrics", timeout=30).read().decode()
                    scraped["problems"] = check_prometheus.validate(
                        body, require_labels=(("stage", "sgx_mapper"),
                                              ("stage", "sgx_filter")),
                        min_samples=20)
                    scraped["bytes"] = len(body)
                yield c

        REGISTRY.reset(prefix="ft.")
        pipeline_mod.reset_host_sync_count()
        try:
            (out, wall), _ = counted_run(torch, f"obs_{form}", "enclave",
                                         _timed(torch, p, source(), **kw))
        finally:
            if server is not None:
                server.stop()
        _check_flights(f"observation cost {form}", out, ref)
        rep = p.report()
        windows = rep["dispatch"]["ingress"]["windows"]
        got = {"host_syncs_per_window":
               pipeline_mod.host_sync_count() / windows,
               "dispatches_per_hop": {
                   "ingress": rep["dispatch"]["ingress"]["dispatches"]
                   / windows,
                   **{s: rep[s]["dispatches_per_window"]
                      for s in ("sgx_mapper", "sgx_filter")},
                   "egress": rep["dispatch"]["egress"]["dispatches"]
                   / rep["dispatch"]["egress"]["windows"]}}
        if shape and got != shape:
            raise AssertionError(f"observation cost: form {form} has "
                                 f"{got}, bare has {shape}")
        shape = shape or got
        rates[form].append(n / wall)
        if form == "ft":
            det = p._last_ft.detector("sgx_mapper")
            scraped["ft_backups"] = ft_counters()["backups"]
            scraped["ft_cutoff_s"] = policy.timeout_for(det)
            scraped["ft_mean_share_ms"] = det.mean * 1e3
        if form == "tracer":
            scraped["spans"] = len(kw["tracer"].spans)
    if scraped.get("problems"):
        raise AssertionError(f"observation cost: the scraped body is not "
                             f"valid: {scraped['problems'][:5]}")
    phase("observation_cost", records=n, order="ABCDDCBA",
          **{f"{f}_records_per_s": "/".join(f"{r:.1f}" for r in rates[f])
             for f in forms},
          host_syncs_per_window=shape["host_syncs_per_window"],
          dispatches_per_hop=json.dumps(shape["dispatches_per_hop"],
                                        separators=(",", ":")),
          equal_across_forms=True, scrape_valid=True,
          scrape_bytes=scraped["bytes"], tracer_spans=scraped["spans"],
          ft_backups_adaptive=scraped["ft_backups"],
          ft_adaptive_cutoff_s=scraped["ft_cutoff_s"],
          ft_mean_share_enqueue_ms=round(scraped["ft_mean_share_ms"], 4))
    return rates


def phase_trace(torch, dev, busy_ms_per_window=None):
    """Phase 11d: a traced DelayedFlights run of TRACE_WINDOWS windows
    (phase 3's job and profiled length), exported as Chrome JSON to
    TRACE_PATH: host ms a window by span name beside phase 3's profiled
    device-busy ms a window.  Spans are host time: around a launch they
    measure its enqueue; the device's time shows in ``sync.verdicts``,
    where the host waits for the window's kernels."""
    from collections import defaultdict
    from repro_torch.data.synthetic import flight_records
    from repro_torch.obs import Tracer
    from repro_torch.u32 import from_numpy
    n_chunks = TRACE_WINDOWS * WINDOW
    recs = flight_records(n_chunks * CHUNK_RECORDS, seed=2)
    recs_dev = from_numpy(recs, dev)
    _flights_pipeline("enclave", 1, dev).run(_chunks(recs_dev, WINDOW * 2))
    tr = Tracer()
    p = _flights_pipeline("enclave", 1, dev)
    (out, wall), _ = counted_run(torch, "traced", "enclave", _timed(
        torch, p, _chunks(recs_dev, n_chunks), tracer=tr))
    _check_flights("traced run", out, _numpy_flights(recs))
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    doc = tr.export_chrome(str(TRACE_PATH))
    json.loads(TRACE_PATH.read_text())
    total = defaultdict(float)
    count = defaultdict(int)
    for s in tr.spans:
        total[s.name] += s.dur
        count[s.name] += 1
    phase("trace", windows=TRACE_WINDOWS, records=n_chunks * CHUNK_RECORDS,
          wall_ms_per_window=round(wall / TRACE_WINDOWS * 1e3, 4),
          spans=len(tr.spans), events=len(doc["traceEvents"]),
          spans_per_window=round(len(tr.spans) / TRACE_WINDOWS, 2),
          device_busy_ms_per_window=(
              "not measured" if busy_ms_per_window is None
              else round(busy_ms_per_window, 4)),
          chrome_json=str(TRACE_PATH.relative_to(TRACE_PATH.parents[1])))
    for name in sorted(total, key=lambda k: -total[k]):
        print(f"   host {total[name] / TRACE_WINDOWS * 1e3:9.4f} ms a window"
              f"  {count[name]:6d} spans  {name}", flush=True)



# ------------------------------------------------- phase 12: the secure wire

#: phase 12a: the sealed checkpoint of phase 10's llama3.2-1b parameters
CKPT_DIR = Path(__file__).resolve().parent / "build" / "phase12_ckpt"
CKPT_STEP = 1
#: phase 12b: GPipe at llama3.2-1b's hidden width: S stages of
#: tanh(x @ w), M microbatches of TOKENS x WIDTH f32 (32 MiB a hand-off)
GPIPE_STAGES, GPIPE_MICRO, GPIPE_TOKENS, GPIPE_WIDTH = 4, 8, 4096, 2048
GPIPE_REKEY = 2
#: phase 12c: DelayedFlights records a worker over W workers
ROUTE_WORKERS, ROUTE_RECORDS = 8, 131_072
#: timed repetitions of 12b's schedules and 12c's rounds, in turns
WIRE_REPS = 3
#: words of the plain versions at a time (their int64 temporaries of a
#: whole checkpoint, 150k rows of 4,096 words, would not fit the card)
PLAIN_SLAB_WORDS = 16384 * 4096


class _Evented:
    """Wraps ``module.name`` so every call is bracketed by CUDA events:
    ``ms()`` is the device time of the calls made since (the seal and
    open passes of a checkpoint, apart from its host work)."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.real = getattr(module, name)
        self.events = []

    def __enter__(self):
        def call(*a, **kw):
            start = self.torch.cuda.Event(enable_timing=True)
            stop = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*a, **kw)
            stop.record()
            self.events.append((start, stop))
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _slabbed(torch, fn, n_rows, row_words):
    """``fn(i, j)`` over slabs [i, j) of rows of ``row_words`` words, at
    most PLAIN_SLAB_WORDS a slab; outputs concatenated by row."""
    rows = max(1, PLAIN_SLAB_WORDS // max(1, row_words))
    outs = [fn(i, min(i + rows, n_rows)) for i in range(0, n_rows, rows)]
    return tuple(torch.cat(p) for p in zip(*outs)) \
        if isinstance(outs[0], tuple) else torch.cat(outs)


class _Largest:
    """Wraps ``module.name`` (``aead.seal_many`` or ``open_many``) and keeps
    copies of the arguments and results of its call with the most rows:
    one real call of a path, to hold against the plain versions."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.args = self.out = None

    def __enter__(self):
        def call(*a, **kw):
            out = self.real(*a, **kw)
            if self.args is None or a[1].shape[0] > self.args[1].shape[0]:
                self.args = tuple(t.clone() for t in a)
                self.out = tuple(t.clone() for t in out)
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def require_aead_plain(torch, what, seal, open_):
    """Holds the real ``seal_many`` and ``open_many`` calls that ``seal``
    and ``open_`` (:class:`_Largest`) kept bit-equal to the plain cipher
    pass and tags on the same inputs, a slab of rows at a time: ct and
    tags of the seal, pt and verdicts of the open.  -> [(B, n) of the
    seal, (B, n) of the open]."""
    from repro_torch.kernels.chacha20.ref import cipher_pass_ref
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.cwmac.ref import mac_tags_ref
    shapes = []
    for mode, call in (("seal", seal), ("open", open_)):
        if call.args is None:
            raise AssertionError(f"{what}: no {mode}_many call to check")
        key, nonces, words = call.args[:3]
        B, n = words.shape
        bw = cwmac_ops.block_words(n, B)

        def plain(i, j):
            mk, res = cipher_pass_ref(key if key.dim() == 1 else key[i:j],
                                      nonces[i:j], words[i:j])
            maced = res if mode == "seal" else words[i:j]
            return res, mac_tags_ref(maced, mk[:, 0::2], mk[:, 1::2], bw)
        res, tags = _slabbed(torch, plain, B, n)
        require_equal(f"{what}: {mode}_many's words", call.out[0], res)
        if mode == "seal":
            require_equal(f"{what}: seal_many's tags", call.out[1], tags)
        else:
            ok = (tags == call.args[3]).all(dim=-1)
            require_equal(f"{what}: open_many's verdicts",
                          call.out[1].to(torch.int32), ok.to(torch.int32))
        shapes.append((B, n))
    return shapes


def _tree_equal(torch, a, b, path=""):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"restored keys differ at {path or '/'}")
        return sum(_tree_equal(torch, a[k], b[k], f"{path}/{k}") for k in a)
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device \
            or not torch.equal(a, b):
        raise AssertionError(f"restored leaf {path} differs")
    return 1


def phase_sealed_checkpoint(torch, dev):
    """Phase 12a: the sealed checkpoint of llama3.2-1b's 1,235,814,400 bf16
    parameters (phase 10's ``_serve_model``), saved and restored on the
    card, every leaf equal; a flipped byte of ``arrays.sealed`` and a
    dropped last row (with its tag and the length) each raise.  Then the
    cipher pass (row 1) and the CW-MAC tags (row 2) at the store's shape,
    bit-equal to their plain versions and timed against their bounds, and
    a cold and a warm seal of that shape profiled.
    -> ({run: launches}, {row name: numbers at the checkpoint's shape})."""
    import json
    import shutil

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.kernels.chacha20 import ops as chacha_ops
    from repro_torch.kernels.chacha20.ref import cipher_pass_ref
    from repro_torch.kernels.cwmac import ops as cwmac_ops
    from repro_torch.kernels.cwmac.ref import mac_tags_ref
    cfg, params, _, init_s = _serve_model(torch, dev)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    launches = {}

    def save():
        with _Evented(torch, ckpt.aead, "seal_many") as ev:
            t0 = time.perf_counter()
            final = ckpt.save(str(CKPT_DIR), CKPT_STEP, params, {},
                              device=dev)
            torch.cuda.synchronize()
            return final, time.perf_counter() - t0, ev.ms()
    (final, save_s, seal_ms), launches["ckpt_save"] = counted_run(
        torch, "sealed_checkpoint_save", "encrypted", save, engine="wire")
    with open(Path(final) / "manifest.json") as f:
        man = json.load(f)
    n_bytes = man["aead"]["n_bytes"]
    n_rows = len(man["aead"]["tags"]) // 16
    if launches["ckpt_save"]["ss_cwmac_tags"] != \
            -(-n_rows // cwmac_ops.MAX_ROWS):
        raise AssertionError(f"the seal of {n_rows} rows launched the tags "
                             f"kernel {launches['ckpt_save']}")

    def restore():
        with _Evented(torch, ckpt.aead, "open_many") as ev:
            t0 = time.perf_counter()
            out = ckpt.restore(str(CKPT_DIR), params_like=params,
                               opt_like={}, device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, ev.ms()
    ((step, restored, opt), restore_s, open_ms), \
        launches["ckpt_restore"] = counted_run(
            torch, "sealed_checkpoint_restore", "encrypted", restore,
            engine="wire")
    leaves = _tree_equal(torch, params, restored)
    n_params = sum(t.numel() for t in ckpt._leaves(params))
    if step != CKPT_STEP or opt != {}:
        raise AssertionError(f"restored step {step}, opt {opt}")
    del restored

    # tamper: one flipped byte of the sealed blob, then a dropped last row
    blob = Path(final) / "arrays.sealed"
    with open(blob, "r+b") as f:
        f.seek(n_bytes // 2)
        byte = f.read(1)
        f.seek(n_bytes // 2)
        f.write(bytes([byte[0] ^ 0x01]))
    for what, match in (("flipped byte", "AEAD verification FAILED on "
                                         "rows"),
                        ("dropped last row", "tag list")):
        if what == "dropped last row":
            with open(blob, "r+b") as f:
                f.seek(n_bytes // 2)
                f.write(byte)
                f.truncate((n_rows - 1) * 4 * 4096)
            bad = dict(man, aead=dict(man["aead"],
                                      tags=man["aead"]["tags"][:-16],
                                      n_bytes=(n_rows - 1) * 4 * 4096))
            with open(Path(final) / "manifest.json", "w") as f:
                json.dump(bad, f)
        try:
            ckpt.restore(str(CKPT_DIR), params_like=params, opt_like={},
                         device=dev)
        except ValueError as e:
            if match not in str(e):
                raise AssertionError(f"{what}: restore raised {e}") from e
        else:
            raise AssertionError(f"{what}: the tampered store restored")
    shutil.rmtree(CKPT_DIR)
    host_save, host_restore = save_s - seal_ms / 1e3, \
        restore_s - open_ms / 1e3
    phase("sealed_checkpoint", arch=SERVE_ARCH, params=n_params,
          dtype="bfloat16", leaves=leaves, blob_bytes=n_bytes, rows=n_rows,
          row_words=4096, init_s=round(init_s, 3), save_s=round(save_s, 3),
          save_host_s=round(host_save, 3), save_device_ms=seal_ms,
          seal_gb_per_s=n_bytes / 1e9 / (seal_ms / 1e3),
          restore_s=round(restore_s, 3),
          restore_host_s=round(host_restore, 3),
          restore_device_ms=open_ms,
          open_gb_per_s=n_bytes / 1e9 / (open_ms / 1e3),
          equal=True, flipped_byte_raises=True, dropped_row_raises=True)
    del params

    # kernels 1 and 2 at the store's shape: (n_rows, 4096) words, one key
    g = torch.Generator(device=dev).manual_seed(12)
    words = torch.randint(-2 ** 31, 2 ** 31, (n_rows, 4096),
                          dtype=torch.int32, device=dev, generator=g)
    key = torch.randint(-2 ** 31, 2 ** 31, (8,), dtype=torch.int32,
                        device=dev, generator=g)
    nonces = torch.randint(-2 ** 31, 2 ** 31, (n_rows, 3),
                           dtype=torch.int32, device=dev, generator=g)
    rows = {}
    mk, ct = chacha_ops.cipher_pass(key, nonces, words)
    pmk, pct = _slabbed(torch, lambda i, j: cipher_pass_ref(
        key, nonces[i:j], words[i:j]), n_rows, 4096)
    require_equal("cipher pass at the checkpoint's shape", ct, pct)
    require_equal("MAC keys at the checkpoint's shape", mk, pmk)
    del pmk, pct, ct
    b, by = bound(*pass_work(n_rows, 4096))
    ms = device_ms(torch, lambda: chacha_ops.cipher_pass(key, nonces, words),
                   2, reps=3)
    plain_ms = _events_ms(torch, lambda: _slabbed(
        torch, lambda i, j: cipher_pass_ref(key, nonces[i:j], words[i:j]),
        n_rows, 4096), 1)
    rows["chacha20_cipher_pass_batch"] = dict(
        shape=f"{n_rows} x 4096", ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, max_abs_err=0)
    phase("kernel_shape", name="chacha20_cipher_pass_batch",
          shape=f"checkpoint {n_rows}x4096", bit_equal=True, ms=ms,
          plain_ms=plain_ms, bound_ms=b, bound_by=by, share_of_bound=b / ms)

    def tags():
        return cwmac_ops.mac2_batch(words, mk[:, 0], mk[:, 1], mk[:, 2],
                                    mk[:, 3])

    def plain_tags():
        bw = cwmac_ops.block_words(4096, n_rows)
        return _slabbed(torch, lambda i, j: mac_tags_ref(
            words[i:j], mk[i:j, 0::2], mk[i:j, 1::2], bw), n_rows, 4096)
    before = cwmac_ops.KERNEL.launches
    got = tags()
    a_call = cwmac_ops.KERNEL.launches - before
    if a_call != -(-n_rows // cwmac_ops.MAX_ROWS):
        raise AssertionError(f"the tags kernel launched {a_call} times over "
                             f"{n_rows} rows")
    require_equal("cwmac tags at the checkpoint's shape", got, plain_tags())
    b, by = bound(n_rows * 4096 * 4 + n_rows * 6 * 4,
                  2 * n_rows * 4096 * CWMAC_OPS_PER_WORD)
    ms = device_ms(torch, tags, 2, reps=3)
    plain_ms = _events_ms(torch, plain_tags, 1)
    rows["cwmac_tags"] = dict(
        shape=f"{n_rows} x 4096", ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, max_abs_err=0, launches_a_call=a_call)
    phase("kernel_shape", name="cwmac_tags",
          shape=f"checkpoint {n_rows}x4096", bit_equal=True, ms=ms,
          plain_ms=plain_ms, bound_ms=b, bound_by=by, share_of_bound=b / ms,
          launches_a_call=a_call)

    # the save's seal took more device time than its two kernels: one seal
    # at the store's shape from an emptied cache allocator and one warm,
    # each profiled, CUDA events around the call and around its cipher
    # pass and tags calls (each with its output's allocation)
    from torch.profiler import ProfilerActivity, profile
    del got, mk
    seal = {}
    for state in ("cold", "warm"):
        torch.cuda.synchronize()
        if state == "cold":
            torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                _Evented(torch, ckpt.aead, "seal_many") as ev, \
                _Evented(torch, chacha_ops, "cipher_pass") as ev_pass, \
                _Evented(torch, cwmac_ops, "mac2_batch") as ev_tags:
            ckpt.aead.seal_many(key, nonces, words)
            seal[f"{state}_event_ms"] = ev.ms()
            seal[f"{state}_pass_event_ms"] = ev_pass.ms()
            seal[f"{state}_tags_event_ms"] = ev_tags.ms()
        mallocs = [e for e in prof.key_averages()
                   if e.key.startswith("cudaMalloc")]
        kernels = device_rows(prof)
        seal[f"{state}_kernels_ms"] = sum(r[1] for r in kernels) / 1e3 \
            if kernels else "not measured (no device time in the trace)"
        seal[f"{state}_malloc_ms"] = sum(e.cpu_time_total
                                         for e in mallocs) / 1e3
        seal[f"{state}_mallocs"] = sum(e.count for e in mallocs)
    phase("seal_allocator", shape=f"{n_rows}x4096", **seal)
    return launches, rows


def profile_wire(torch, what, fn):
    """One warm call of ``fn()`` under torch.profiler: wall, the device's
    busy ms and share, and the device kernels and copies that take it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_rows(prof), key=lambda r: -r[1])
    if not rows:
        phase("wire_profile", run=what, wall_ms=wall_ms, device_busy=(
            "not measured (no device time in the trace)"))
        return
    busy_ms = sum(r[1] for r in rows) / 1e3
    phase("wire_profile", run=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
          device_busy_share=busy_ms / wall_ms)
    for key, t, count in rows[:8]:
        print(f"   device {t / 1e3:10.4f} ms  {count:5d} calls  {key[:90]}",
              flush=True)


def _wire_calls():
    """{AEAD seal calls, open calls, exchanges} so far (the port's
    registry)."""
    from repro_torch.obs.metrics import REGISTRY
    return {k: int(REGISTRY.counter(c).value) for k, c in (
        ("seal", "device.dispatches.aead.seal_many"),
        ("open", "device.dispatches.aead.open_many"),
        ("exchange", "dist.exchange_calls"))}


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


def phase_sealed_gpipe(torch, dev):
    """Phase 12b: ``pipeline_apply`` with S = 4 stages of tanh(x @ w) at
    llama3.2-1b's hidden width (w (4, 2048, 2048) f32) over M = 8
    microbatches of 4,096 x 2,048 (32 MiB a hand-off): unsealed, sealed,
    and sealed with ``rekey_every_n=2`` on an explicit directory, each
    bit-equal to chaining the stages one microbatch at a time; a tampered
    hand-off raises ``PipelineMACError``.  -> {run: launches}."""
    from repro_torch.crypto import aead
    from repro_torch.dist import pipeline_parallel as pp
    S, M, T, D = GPIPE_STAGES, GPIPE_MICRO, GPIPE_TOKENS, GPIPE_WIDTH
    g = torch.Generator(device=dev).manual_seed(21)
    w = torch.randn((S, D, D), device=dev, generator=g) / math.sqrt(D)
    xs = torch.randn((M, T, D), device=dev, generator=g)

    def stage(wi, x):
        return torch.tanh(x @ wi)

    def chain():
        outs = []
        for m in range(M):
            x = xs[m]
            for s in range(S):
                x = stage(w[s], x)
            outs.append(x)
        return torch.stack(outs)
    want = chain()
    # a fresh step for every sealed schedule on the shared default
    # directory: its edge counters are step * M + microbatch
    steps = iter(range(1, 1 << 20))
    d = pp.edge_directory(S, seed=0)
    runs = {"plain": dict(seal=False), "sealed": dict(seal=True),
            "sealed_rekey": dict(seal=True, directory=d,
                                 rekey_every_n=GPIPE_REKEY)}
    launches, calls, checked = {}, {}, {}
    for name, kw in runs.items():
        c0 = _wire_calls()
        with _Largest(aead, "seal_many") as seal, \
                _Largest(aead, "open_many") as open_:
            out, launches[name] = counted_run(
                torch, f"gpipe_{name}", "plain" if name == "plain"
                else "encrypted", lambda: pp.pipeline_apply(
                    stage, w, xs, step=next(steps), **kw),
                engine="wire")
        calls[name] = _delta(c0, _wire_calls())
        if not torch.equal(out, want):
            raise AssertionError(f"gpipe {name}: differs from chaining the "
                                 f"stages")
        if name != "plain":
            checked[name] = require_aead_plain(torch, f"gpipe {name}", seal,
                                               open_)
        del seal, open_
    if d.epoch != (M + S - 1) // GPIPE_REKEY:
        raise AssertionError(f"the rekeyed schedule ended at epoch "
                             f"{d.epoch}")

    # a tampered hand-off: one ciphertext word flipped into stage 2,
    # microbatch 3
    real = pp.unprotect_many

    def tampered(keys, counters, cts, tags, meta):
        for i, (k, st) in enumerate(zip(keys, counters)):
            if k.stage_id == 2 and st % M == 3:
                cts = cts.clone()
                cts[i, 7] ^= 0x10
        return real(keys, counters, cts, tags, meta)
    pp.unprotect_many = tampered
    try:
        pp.pipeline_apply(stage, w, xs, step=next(steps))
    except pp.PipelineMACError as e:
        if str(e) != "MAC failure on edge into stage 2, microbatch 3":
            raise AssertionError(f"tamper named {e}") from e
    else:
        raise AssertionError("a tampered hand-off opened")
    finally:
        pp.unprotect_many = real

    ticks = M + S - 1
    syncs, sites = host_syncs(torch, lambda: pp.pipeline_apply(
        stage, w, xs, step=next(steps)))
    for name in ("plain", "sealed"):
        profile_wire(torch, f"gpipe_{name}", lambda: pp.pipeline_apply(
            stage, w, xs, seal=name == "sealed", step=next(steps)))
    ms = {"plain": [], "sealed": []}
    for name in ("plain", "sealed", "sealed", "plain") * WIRE_REPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp.pipeline_apply(stage, w, xs, seal=name == "sealed",
                          step=next(steps))
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    sealed = calls["sealed"]
    phase("sealed_gpipe", stages=S, microbatches=M, tokens=T, width=D,
          handoff_mib=T * D * 4 / 2 ** 20, ticks=ticks,
          equal_plain=True, equal_sealed=True, equal_rekeyed=True,
          aead_plain_equal={k: [f"{b}x{n}" for b, n in v]
                            for k, v in checked.items()},
          tamper_raises=True, rekey_epochs=d.epoch,
          plain_ms=min(ms["plain"]), sealed_ms=min(ms["sealed"]),
          plain_ms_all=ms["plain"], sealed_ms_all=ms["sealed"],
          seal_calls=sealed["seal"], open_calls=sealed["open"],
          seal_calls_a_tick=sealed["seal"] / ticks,
          open_calls_a_tick=sealed["open"] / ticks,
          host_syncs=syncs, host_syncs_a_tick=syncs / ticks,
          sync_sites=",".join(sorted(set(sites))))
    return launches


def _np_hash(k):
    """numpy u32 ``_consistent_hash``: the oracle of 12c's routing."""
    k = k.astype(np.uint32) * np.uint32(0x9E3779B1)
    return k ^ (k >> np.uint32(16))


def phase_keyed_shuffle(torch, dev):
    """Phase 12c: the router's keyed shuffle of DelayedFlights records
    (16 words, 64 B) from ``data.synthetic``, 131,072 a worker over W = 8
    workers on the ``model`` axis, keyed by carrier, plain and over sealed
    channels: every record arrives exactly once at worker hash(carrier) %
    8 (numpy), the counts sum to 8 x 131,072 and every verdict is true;
    ``secure_exchange`` of the same mailbox equals its transpose; a
    flipped wire word fails exactly that block.  -> {run: launches}."""
    from repro_torch.attest.directory import ephemeral_edge_key
    from repro_torch.core.router import _bucket, route_keyed_sharded
    from repro_torch.crypto import aead
    from repro_torch.data.synthetic import CARRIER_WORD, flight_records
    from repro_torch.dist import collectives as col
    from repro_torch.dist.meshctx import make_mesh
    from repro_torch.u32 import from_numpy
    W, n = ROUTE_WORKERS, ROUTE_RECORDS
    recs = flight_records(W * n, seed=12).reshape(W, n, 16)
    x = from_numpy(recs, dev)
    keys = x[:, :, CARRIER_WORD].contiguous()
    mesh = make_mesh((W,), ("model",), device=dev)
    key = ephemeral_edge_key("shuffle", seed=12)
    dest = (_np_hash(recs[:, :, CARRIER_WORD]) % W).astype(np.int64)
    launches, calls, step = {}, {}, 0
    for name in ("plain", "sealed"):
        kw = dict(key=key, step=step) if name == "sealed" else {}
        step += 1
        c0 = _wire_calls()
        with _Largest(aead, "seal_many") as seal, \
                _Largest(aead, "open_many") as open_:
            (inbox, counts, ok), launches[name] = counted_run(
                torch, f"keyed_route_{name}",
                "encrypted" if name == "sealed" else "plain",
                lambda: route_keyed_sharded(x, keys, mesh, **kw),
                engine="wire")
        calls[name] = _delta(c0, _wire_calls())
        if name == "sealed":
            checked = require_aead_plain(torch, "keyed route sealed", seal,
                                         open_)
        del seal, open_
        counts_h, inbox_h = counts.cpu().numpy(), inbox.cpu().numpy()
        if not bool(ok.all()) or int(counts_h.sum()) != W * n:
            raise AssertionError(f"keyed route {name}: verdicts or counts "
                                 f"wrong ({int(counts_h.sum())} rows)")
        for j in range(W):
            for src in range(W):
                got = inbox_h[j, src, :counts_h[j, src]].view(np.uint32)
                if not np.array_equal(got, recs[src][dest[src] == j]):
                    raise AssertionError(f"keyed route {name}: block "
                                         f"({src} -> {j}) differs")
        del inbox, inbox_h
    if calls["sealed"] != {"seal": 1, "open": 1, "exchange": 1}:
        raise AssertionError(f"a sealed round made {calls['sealed']}")

    mailbox, bucket_counts = _bucket(x, torch.from_numpy(dest).to(dev), W)
    y, ok = col.secure_exchange(mailbox, mesh, key=key, step=step)
    step += 1
    if not bool(ok.all()) or not torch.equal(y, mailbox.transpose(0, 1)):
        raise AssertionError("secure_exchange differs from the transpose")
    del y

    # the wire exposed: the sealed round's pieces, one word flipped in
    # block (src 3 -> dst 5)
    payload = torch.cat([mailbox.reshape(W, W, -1),
                         bucket_counts[..., None]], dim=-1)
    n_words = payload.shape[-1]
    kw_t = torch.from_numpy(key.key).to(dev)
    nonces = col._route_nonces_base(W, step * W * W, dev)
    ct, tags = aead.seal_many(kw_t, nonces, payload.reshape(W * W, -1))
    wire = torch.cat([ct, tags], -1).reshape(W, W, -1)
    wire[3, 5, n_words // 2] ^= 0x4
    got = col.exchange(wire, mesh).reshape(W * W, -1)
    nonces_in = nonces.reshape(W, W, 3).transpose(0, 1).reshape(W * W, 3)
    _, ok = aead.open_many(kw_t, nonces_in, got[:, :n_words],
                           got[:, n_words:])
    want = torch.ones((W, W), dtype=torch.bool, device=dev)
    want[5, 3] = False
    if not torch.equal(ok.reshape(W, W), want):
        raise AssertionError("a flipped wire word did not fail exactly its "
                             "block")
    del wire, got, ct, payload, mailbox

    steps = iter(range(step + 1, 1 << 20))   # a fresh step every round
    for name in ("plain", "sealed"):
        profile_wire(torch, f"keyed_route_{name}", lambda: route_keyed_sharded(
            x, keys, mesh, **(dict(key=key, step=next(steps))
                              if name == "sealed" else {})))
    ms = {"plain": [], "sealed": []}
    for name in ("plain", "sealed", "sealed", "plain") * WIRE_REPS:
        kw = dict(key=key, step=next(steps)) if name == "sealed" else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        route_keyed_sharded(x, keys, mesh, **kw)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    mb = W * n * 64 / 1e6
    phase("keyed_shuffle", workers=W, records_a_worker=n, record_bytes=64,
          mailbox_mb=W * W * n * 64 / 1e6, payload_rows=W * W,
          payload_words=n_words, exactly_once=True,
          aead_plain_equal=[f"{b}x{n}" for b, n in checked],
          transpose_equal=True, flipped_word_fails_its_block=True,
          plain_ms=min(ms["plain"]), sealed_ms=min(ms["sealed"]),
          plain_mb_per_s=mb / (min(ms["plain"]) / 1e3),
          sealed_mb_per_s=mb / (min(ms["sealed"]) / 1e3),
          plain_ms_all=ms["plain"], sealed_ms_all=ms["sealed"],
          sealed_round_calls=calls["sealed"],
          plain_round_calls=calls["plain"])
    return launches


def phase_secure_wire(torch, dev):
    """Phase 12: 12a, 12b and 12c.  -> ({run: launches}, {row name: the
    numbers of rows 1 and 2 at the checkpoint's shape})."""
    t0 = time.perf_counter()
    launches, rows = phase_sealed_checkpoint(torch, dev)
    t1 = time.perf_counter()
    launches.update({f"gpipe_{k}": v for k, v in
                     phase_sealed_gpipe(torch, dev).items()})
    t2 = time.perf_counter()
    launches.update({f"keyed_route_{k}": v for k, v in
                     phase_keyed_shuffle(torch, dev).items()})
    phase("secure_wire", seconds=round(time.perf_counter() - t0, 3),
          checkpoint_s=round(t1 - t0, 3), gpipe_s=round(t2 - t1, 3),
          shuffle_s=round(time.perf_counter() - t2, 3))
    return launches, rows


# --------------------------------------------- phase 13: secure training

#: phase 13's model, batch and run: llama3.2-1b at full width and depth,
#: 4 sequences of 2,048 tokens a step, AdamW, remat "full", bf16
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
#: 13c: steps, checkpoint cadence and the injected failure (after the
#: first checkpoint, so the restart restores it and replays a step)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 5, 3, 4
#: 13c: the Trainer's depth (of 16).  Its two sealed checkpoints and one
#: restore move 10 bytes a parameter each through host memory and the
#: disk: 12.4 GB each at full depth (~42 s a save on the H100 host, most
#: of phase 13's time), 3.8 GB at 2 layers; the full depth's steps are
#: timed in 13b and 15a
TRAIN_TRAINER_LAYERS = 2
TRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / "phase13_ckpt"
#: 13a: kernel 7's lse against the plain version's (f32 both; values
#: ~log(keys) ~ 8): the scores' f32 sums in another order, ex2.approx (2
#: ulp) over <= 2,048 terms and the exp2-unit max times ln 2 each move it
#: ~1e-6..1e-5
LSE_TOL = 1e-4
#: 13a: the flash Function's dq/dk/dv (bf16) against autograd through the
#: plain f32 attention: the relative L2 error of each; the Function's
#: inputs to the backward are bf16 (its output rounds at 2^-9, and delta =
#: sum(do * out) reads it) and its gradients round to bf16 (2^-9)
GRAD_RTOL = 1e-2
#: 13b: the loss and the global gradient norm of one step with kernel 7
#: ("flash") and with the plain "chunked" attention.  Two bf16 runs that
#: differ in rounding drift ~2^-4 on a logit over the 16 layers (phase
#: 10's SERVE_LOGIT_TOL); the loss averages 8,192 tokens' NLL (~11.8),
#: so 1e-2 leaves a wide margin; the norm is dominated by the largest
#: leaves, whose elements differ by bf16 rounding: 2e-2 relative
TRAIN_LOSS_TOL = 1e-2
TRAIN_GNORM_RTOL = 2e-2
#: 13b: the attention leaves' gradients (wq, wk, wv, wo of every layer),
#: which the loss and the norm hardly see at random init.  In f32 the two
#: steps differ only in attention's forward (kernel 7's f32 kernel, ~1e-6
#: from the plain one) and in the order of the backward's sums, so each
#: leaf's relative L2 gap must stay under ATTN_GRAD_F32_RTOL; a wrong
#: backward moves it by O(1).  In bf16 every product of the network
#: rounds, which leaves both bf16 steps ~2e-2 from the f32 step: the
#: flash step's attention leaves may be no farther from the f32 chunked
#: step than ATTN_GRAD_BF16_RATIO times the bf16 chunked step's are.
#: Measured on an H100 80GB HBM3 (700 W): 6.0e-6..8.0e-6 in f32; in bf16
#: 2.19e-2..2.83e-2 (flash) against 2.21e-2..2.84e-2 (chunked)
ATTN_GRAD_F32_RTOL = 1e-4
ATTN_GRAD_BF16_RATIO = 1.5
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
#: 13c: the first loss of random weights (embedding std 0.02: near-uniform
#: logits) lies within 1.0 of ln(vocab)
TRAIN_LOSS0_TOL = 1.0
CARD = ""                       # "name, power limit" (nvidia-smi), phase 1


def train_data_fn(vocab: int):
    """``examples/secure_lm_train.py``'s learnable recipe at phase 13's
    shape: noisy modular ramps, deterministic per step (replay)."""
    def data_fn(step: int):
        rng = np.random.default_rng(1000 + step)
        start = rng.integers(0, vocab, (TRAIN_BATCH, 1))
        ramp = (start + np.arange(TRAIN_SEQ + 1)[None]) % vocab
        noise = rng.integers(0, vocab, ramp.shape)
        keep = rng.random(ramp.shape) < 0.9
        toks = np.where(keep, ramp, noise).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return data_fn


def _train_run(layers=None):
    """llama3.2-1b's run config with the "train_4k" shape (256 sequences
    of 4,096 tokens) cut to phase 13's 4 of 2,048, for one card's time;
    at ``layers`` of its 16 when given."""
    from repro_torch.configs import SHAPES, get_model_config, get_run_config
    cfg = get_model_config(TRAIN_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    run = get_run_config(TRAIN_ARCH, "train_4k", model=cfg, remat="full")
    return dataclasses.replace(run, shape=dataclasses.replace(
        SHAPES["train_4k"], name="train_4k-cut", seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH))


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def phase_train_attention(torch, dev):
    """Phase 13a: kernel 7's out and lse against the plain version, and
    the flash Function's gradients (kernels 7 and 8) against autograd
    through plain attention, at llama3.2-1b's training shape; then kernel
    7's time with and without the lse, and kernel 8 beside its bound, the
    block recompute, the plain attention's backward and SDPA's, at that
    shape and at musicgen's (B 3).  -> numbers."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_RTOL, NEG_INF, attention_ref, bf16_mismatch)
    from repro_torch.launch.dryrun import PEAK_FLOPS
    from repro_torch.models.flash import flash_attention
    cfg = _train_run().model
    B, H, S, D = TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    bhsd = lambda t: t.transpose(1, 2)          # noqa: E731
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        out, lse = flash_ops.flash_attention(qq, kk, vv, causal=True,
                                             return_lse=True)
        want, want_lse = attention_ref(bhsd(qq), bhsd(kk), bhsd(vv),
                                       causal=True, return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        name = str(dtype).removeprefix("torch.")
        if dtype == torch.bfloat16:
            err, excess, row_rel = bf16_mismatch(bhsd(out), want, bhsd(qq),
                                                 bhsd(kk), bhsd(vv))
            ok = excess <= 0 and row_rel <= BF16_ROW_RTOL
            more = dict(out_excess=excess, out_row_rel_err=row_rel,
                        out_row_rtol=BF16_ROW_RTOL)
        else:
            err = (bhsd(out) - want).abs().max().item()
            ok, more = err <= F32_TOL, dict(out_tol=F32_TOL)
        ok = ok and lse_err <= LSE_TOL and tuple(lse.shape) == (B, H, S)
        phase("train_flash_check", card=CARD, dtype=name,
              shape=f"{B}x{S}x{H}x{D}", out_max_abs_err=err, **more,
              lse_max_abs_err=lse_err, lse_tol=LSE_TOL, ok=ok)
        if not ok:
            failed.append(f"forward {name}")
        del out, lse, want, want_lse
    # the Function's gradients against autograd through plain f32
    # attention of the same (bf16-valued) inputs
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qg, kg, vg, True, 512, 1024)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    keep = torch.ones((S, S), dtype=torch.bool, device=dev).tril()

    def plain_attention(a, b, c):
        s = bhsd(a) @ bhsd(b).transpose(-1, -2) / math.sqrt(D)
        s = s.masked_fill(~keep, NEG_INF)
        return (torch.softmax(s, dim=-1) @ bhsd(c)).transpose(1, 2)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(plain_attention(qf, kf, vf), (qf, kf, vf),
                               do.float())
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = _rel_l2(a, b)
        ok = rel <= GRAD_RTOL and a.dtype == torch.bfloat16
        phase("train_flash_grad", card=CARD, grad=name,
              max_abs_err=(a.float() - b).abs().max().item(),
              rel_l2_err=rel, rel_l2_tol=GRAD_RTOL, ok=ok)
        if not ok:
            failed.append(name)
    del got, want, qf, kf, vf
    if failed:
        raise AssertionError(f"phase 13a: {failed} differ from the plain "
                             f"versions")
    # kernel 7 with and without the lse, in turns
    fwd = lambda lse: (lambda: flash_ops.flash_attention(   # noqa: E731
        q, k, v, causal=True, return_lse=lse))
    t = [eager_ms(torch, fwd(lse), 20) for lse in (False, True, True, False)]
    no_lse_ms, lse_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    flops = flash_flops(B, H, S, S, D, True)
    fwd_bound, fwd_by = bound(4 * q.numel() * 2 + B * H * S * 4, flops,
                              PEAK_FLOPS)
    # the backward: kernel 8 (the Function's, from the forward's out and
    # lse), the plain block recompute it replaced, autograd through the
    # materialized f32 attention and SDPA's; at this shape (row 8's) and at
    # musicgen-selfattn-2.4b's (the training cells': B 3)
    from repro_torch.kernels import build
    from repro_torch.models.flash import flash_backward_plain

    def backward_ms(fn, inputs, grad, iters):
        x = [t.detach().clone().requires_grad_() for t in inputs]
        y = fn(*x)
        return eager_ms(torch, lambda: torch.autograd.grad(
            y, x, grad, retain_graph=True), iters)
    k8 = [k for k in build.ptxas_kernels(build.ptxas_report())
          if "flash_bwd" in k["name"]]
    spills = sum(k["spill_stores"] + k["spill_loads"] for k in k8)
    regs = "/".join(f"{k['name'].split('flash_bwd_')[1].split('E')[0]}:"
                    f"{k['registers']}" for k in k8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_numbers = {}
    for tag, b in (("row8", B), ("musicgen", 3)):
        qb, kb, vb, dob = (t[:b] for t in (q, k, v, do))
        out, lse = flash_ops.flash_attention(qb, kb, vb, causal=True,
                                             return_lse=True)
        bwd_ms = eager_ms(torch, lambda: flash_ops.flash_attention_backward(
            qb, kb, vb, out, lse, dob, causal=True), 20)
        block_ms = eager_ms(torch, lambda: flash_backward_plain(
            qb, kb, vb, out, lse, dob, True, 512, 1024), 3)
        plain_bwd_ms = backward_ms(plain_attention, (
            qb.float(), kb.float(), vb.float()), dob.float(), 2)
        sdpa_bwd_ms = backward_ms(
            lambda a, c, e: sdpa(a, c, e, is_causal=True),
            (bhsd(qb), bhsd(kb), bhsd(vb)), bhsd(dob), 10)
        # the backward's work: 5 products of 2 D flops an attended pair
        # (the score recompute, dv, dp, dk, dq) = 2.5x the forward's;
        # bytes: q, k, v, out, do read, dq, dk, dv written (bf16), lse
        # read (f32)
        bflops = flash_flops(b, H, S, S, D, True)
        bwd_bound, bwd_by = bound(8 * qb.numel() * 2 + b * H * S * 4,
                                  2.5 * bflops, PEAK_FLOPS)
        phase("flash_backward", card=CARD,
              shape=f"{b}x{S}x{H}x{D} bf16 causal",
              route="CUDA (kernel 8: csrc/flash_attention_bwd.cu, "
                    "ss_flash_attention_bwd and its preprocess and convert)",
              ms=bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by,
              share_of_bound=bwd_bound / bwd_ms,
              block_recompute_ms=block_ms, plain_ms=plain_bwd_ms,
              library_ms=sdpa_bwd_ms,
              library_call="scaled_dot_product_attention(is_causal=True) "
                           "backward", vs_library=bwd_ms / sdpa_bwd_ms,
              registers=regs, spill_bytes=spills)
        out_numbers[tag] = dict(backward_ms=bwd_ms,
                                backward_bound_ms=bwd_bound,
                                backward_library_ms=sdpa_bwd_ms,
                                backward_block_ms=block_ms,
                                backward_plain_ms=plain_bwd_ms)
        del out, lse
    phase("flash_lse_time", card=CARD, shape=f"{B}x{S}x{H}x{D} bf16 causal",
          ms_without_lse=no_lse_ms, ms_with_lse=lse_ms,
          lse_cost=lse_ms / no_lse_ms - 1, bound_ms=fwd_bound,
          bound_by=fwd_by, runs_ms="/".join(f"{x:.4f}" for x in t))
    if spills:
        raise AssertionError(f"phase 13a: kernel 8 spills ({regs}: "
                             f"{spills} bytes)")
    return dict(ms_with_lse=lse_ms, ms_without_lse=no_lse_ms,
                **out_numbers["row8"],
                musicgen_backward_ms=out_numbers["musicgen"]["backward_ms"])


class _Recorded:
    """Wraps ``module.name`` and keeps each call's first argument and its
    result (of ``optimizers._global_norm``: the gradients before clipping
    and their global norm)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def call(*a, **kw):
            out = self.real(*a, **kw)
            self.calls.append((a[0], out))
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def _train_step_grads(torch, run, impl, params, batch, what):
    """One train step of ``run`` with ``attn_impl=impl``, counted: its
    loss, the gradients and their global norm (before clipping), its
    wall time, peak memory and kernel 7 launches (and kernel 8's three,
    in bf16 with ``"flash"``)."""
    from repro_torch.optim import optimizers
    from repro_torch.train.steps import make_train_step
    step, opt = make_train_step(run, attn_impl=impl)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _Recorded(optimizers, "_global_norm") as rec:
        t0 = time.perf_counter()
        f32 = next(iter(optimizers.tree_leaves(params))).dtype \
            == torch.float32
        (_, _, metrics), launches = counted_run(
            torch, what, f"{impl}_f32" if f32 and impl == "flash" else impl,
            lambda: step(params, state, batch, 0), engine="train_step")
        secs = time.perf_counter() - t0
    grads, norm = rec.calls[0]
    return dict(loss=float(metrics["loss"]), norm=float(norm), grads=grads,
                s=secs, peak=torch.cuda.max_memory_allocated(),
                flash=launches.get("ss_flash_attention_fwd", 0))


def phase_train_step_both_ways(torch, dev, params):
    """Phase 13b: one full-width train step with kernel 7 (``"flash"``)
    and one with the plain ``"chunked"`` attention, from the same
    parameters and batch, in bf16 and again in f32: the bf16 losses and
    global gradient norms agree; the attention leaves' gradients of the
    two f32 steps agree to f32 rounding, and the bf16 flash step's are no
    farther from the f32 step's than the bf16 chunked step's are."""
    from repro_torch.optim import optimizers
    run = _train_run()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             train_data_fn(run.model.vocab_size)(0).items()}
    out = {}
    for impl in ("flash", "chunked"):
        out[impl] = _train_step_grads(torch, run, impl, params, batch,
                                      f"train_step_{impl}")
    params32 = optimizers.tree_map(lambda t: t.float(), params)
    for impl in ("flash", "chunked"):
        out[impl + "_f32"] = _train_step_grads(
            torch, run, impl, params32, batch, f"train_step_{impl}_f32")
    del params32
    f, c = out["flash"], out["chunked"]
    rel = math.sqrt(sum(
        float((a.float() - b.float()).square().sum())
        for a, b in zip(optimizers.tree_leaves(f["grads"]),
                        optimizers.tree_leaves(c["grads"])))) / c["norm"]

    def attn(which):
        return out[which]["grads"]["layers"]["attn"]
    want = attn("chunked_f32")
    attn_rel = {name: {k: _rel_l2(attn(which)[k], want[k])
                       for k in ATTN_LEAVES}
                for name, which in (("f32_flash", "flash_f32"),
                                    ("bf16_flash", "flash"),
                                    ("bf16_chunked", "chunked"))}
    attn_ok = all(attn_rel["f32_flash"][k] <= ATTN_GRAD_F32_RTOL
                  and attn_rel["bf16_flash"][k] <= ATTN_GRAD_BF16_RATIO
                  * attn_rel["bf16_chunked"][k] for k in ATTN_LEAVES)
    ok = (abs(f["loss"] - c["loss"]) <= TRAIN_LOSS_TOL
          and abs(f["norm"] - c["norm"]) <= TRAIN_GNORM_RTOL * c["norm"]
          and math.isfinite(f["loss"]) and attn_ok
          and f["flash"] == out["flash_f32"]["flash"]
          == 2 * run.model.num_layers)
    phase("train_step_both_ways", card=CARD, arch=TRAIN_ARCH,
          batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", remat=run.remat,
          optimizer=run.optimizer.name, loss_flash=f["loss"],
          loss_chunked=c["loss"], loss_tol=TRAIN_LOSS_TOL,
          grad_norm_flash=f["norm"], grad_norm_chunked=c["norm"],
          grad_norm_rtol=TRAIN_GNORM_RTOL, grads_rel_l2=rel,
          loss_flash_f32=out["flash_f32"]["loss"],
          loss_chunked_f32=out["chunked_f32"]["loss"],
          attn_grads_rel_l2_vs_f32_chunked=attn_rel,
          attn_f32_rtol=ATTN_GRAD_F32_RTOL,
          attn_bf16_ratio=ATTN_GRAD_BF16_RATIO,
          step_s={k: v["s"] for k, v in out.items()},
          peak_gb={k: v["peak"] / 1e9 for k, v in out.items()},
          flash_launches=f["flash"], ok=ok)
    if not ok:
        raise AssertionError("phase 13b: the flash and chunked steps "
                             "disagree (or kernel 7 did not run twice a "
                             "layer)")


def _train_group(name: str) -> str:
    """A device kernel of a training step by kind: kernel 7, the f32
    products (the plain flash backward's), the bf16 products (weights,
    LM head), the AEAD kernels, or the rest (elementwise, reductions,
    copies, fills)."""
    if "flash_fwd" in name:
        return "kernel7"
    if "chacha" in name or "cwmac" in name:
        return "aead"
    if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm_f32" if "f32f32" in name else "gemm_bf16"
    return "other"


def _launch_delta(torch, fn, into):
    """``fn()``, adding the kernels' launches it made to ``into``."""
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    before = build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for k, v in build.launch_counts().items():
        into[k] = into.get(k, 0) + v - before.get(k, 0)
    return out


def phase_secure_training(torch, dev):
    """Phase 13c: ``Trainer.train()`` of llama3.2-1b at full width and
    TRAIN_TRAINER_LAYERS layers with
    sealed batches, sealed checkpoints every TRAIN_CKPT_EVERY steps and a
    ``node_loss`` at TRAIN_FAIL_AT; beside an uninterrupted run of the
    same steps, whose final parameters it must equal bit for bit (both
    under ``torch.use_deterministic_algorithms``).  -> (launches of the
    recovered run by row, numbers)."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ft.failures import FailureInjector
    from repro_torch.launch.dryrun import PEAK_FLOPS
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    run = _train_run(TRAIN_TRAINER_LAYERS)
    cfg = run.model
    data_fn = train_data_fn(cfg.vocab_size)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        # the uninterrupted run: TRAIN_STEPS steps, no checkpoint
        plain = Trainer(run, data_fn, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=10 ** 9, log_every=1,
            ckpt_dir=str(TRAIN_CKPT_DIR / "unused")), device=dev)
        ingest = []
        sealed = plain._sealed_batch

        def timed_batch(step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sealed(step)
            torch.cuda.synchronize()
            ingest.append(time.perf_counter() - t0)
            return out
        plain._sealed_batch = timed_batch
        _, steps_launches = counted_run(
            torch, "train_uninterrupted", "encrypted",
            lambda: plain.run_steps(0, TRAIN_STEPS), engine="train_steps")
        plain._sealed_batch = sealed
        want = [t.cpu() for t in tree_leaves(plain.params)]
        secs = [h["sec_per_step"] for h in plain.history]
        losses = [h["loss"] for h in plain.history]
        # one more step under the profiler: the device's busy share and
        # the flash backward's device time
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            plain.run_steps(TRAIN_STEPS, TRAIN_STEPS + 1)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        rows = device_rows(prof)
        busy = sum(r[1] for r in rows) / 1e6
        bwd = [e for e in prof.key_averages()
               if "FlashAttentionBackward" in e.key
               and "evaluate_function" in e.key]
        bwd_s = sum(e.device_time_total for e in bwd) / 1e6 if bwd else None
        rows.sort(key=lambda r: -r[1])
        # the uninterrupted run's state and snapshot must go before the
        # recovered run's come (24.8 GB each at full depth)
        del plain, prof, sealed, timed_batch
        gc.collect()
        torch.cuda.empty_cache()

        # the recovered run: a failure after the first checkpoint
        base = torch.cuda.memory_allocated()
        tr = Trainer(run, data_fn, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
            log_every=1, ckpt_dir=str(TRAIN_CKPT_DIR)),
            injector=FailureInjector({TRAIN_FAIL_AT: "node_loss"}),
            device=dev)
        ckpt_launches, t = {}, {"save": [], "restore": []}
        for name in ("save", "restore"):
            real = getattr(tr, name)

            def timed(real=real, name=name):
                t0 = time.perf_counter()
                out = _launch_delta(torch, real, ckpt_launches)
                t[name].append(time.perf_counter() - t0)
                return out
            setattr(tr, name, timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted_run(torch, "secure_training", "encrypted",
                                    tr.train, engine="train")
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = tree_leaves(tr.params)
        equal = len(got) == len(want) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want))
        hist = [h["step"] for h in out["history"]]
        with open(Path(TRAIN_CKPT_DIR) / f"step-{TRAIN_CKPT_EVERY:08d}"
                  / "manifest.json") as f:
            ckpt_rows = len(json.load(f)["aead"]["tags"]) // 16
        ckpt_bytes = sum(p.stat().st_size for p in
                         (Path(TRAIN_CKPT_DIR)
                          / f"step-{TRAIN_CKPT_EVERY:08d}").iterdir())
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    step_s = float(np.median(secs[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    # model FLOPs a step: 6 N a token (forward + backward of the weights)
    # and the causal attention's products, forward and backward (3x)
    model_flops = 6 * n * tokens + 3 * cfg.num_layers * flash_flops(
        TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim, True)
    executed = len(out["history"])
    flash_per_step = steps_launches["ss_flash_attention_fwd"] / TRAIN_STEPS
    replayed_equal = out["history"][TRAIN_FAIL_AT - 1]["loss"] == \
        out["history"][TRAIN_FAIL_AT]["loss"] == losses[TRAIN_FAIL_AT - 1]
    ok = (equal and out["final_step"] == TRAIN_STEPS
          and out["restarts"] == 1
          and out["replayed_steps"] == TRAIN_FAIL_AT - TRAIN_CKPT_EVERY
          and hist == [1, 2, 3, 4, 4, 5] and replayed_equal
          and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) <= TRAIN_LOSS0_TOL
          and flash_per_step == 2 * cfg.num_layers
          and len(t["save"]) == 2 and len(t["restore"]) == 2)
    phase("secure_training", card=CARD, arch=TRAIN_ARCH,
          params=n, layers=cfg.num_layers, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, remat=run.remat, optimizer=run.optimizer.name,
          steps=TRAIN_STEPS, steps_executed=executed,
          sec_per_step=step_s, secs="/".join(f"{x:.4f}" for x in secs),
          tokens_per_s=tokens / step_s,
          mfu=model_flops / step_s / PEAK_FLOPS,
          model_tflop_per_step=model_flops / 1e12,
          device_busy_share=round(busy / prof_wall, 4),
          profiled_step_s=prof_wall,
          flash_backward_s=bwd_s,
          flash_backward_share=None if bwd_s is None else bwd_s / prof_wall,
          kernel7_launches_per_step=flash_per_step,
          sealed_ingest_ms_per_step=1e3 * float(np.median(ingest)),
          ckpt_save_s="/".join(f"{x:.3f}" for x in t["save"]),
          ckpt_restore_s="/".join(f"{x:.3f}" for x in t["restore"][1:]),
          ckpt_bytes=ckpt_bytes, ckpt_rows=ckpt_rows,
          train_s=train_s, peak_memory_gb=peak / 1e9,
          allocated_before_gb=base / 1e9,
          restarts=out["restarts"], replayed_steps=out["replayed_steps"],
          final_step=out["final_step"], history_steps=hist,
          losses="/".join(f"{x:.5f}" for x in losses),
          equal_to_uninterrupted=equal,
          deterministic_algorithms=True, ok=ok)
    groups = {}
    for key, tt, _ in rows:
        groups[_train_group(key)] = groups.get(_train_group(key), 0) + tt
    phase("train_profile", card=CARD, wall_ms=prof_wall * 1e3,
          busy_ms=busy * 1e3, **{f"{g}_ms": v / 1e3
                                 for g, v in sorted(groups.items())})
    for key, tt, count in rows[:12]:
        print(f"   device {tt / 1e3:10.3f} ms  {count:7d} calls  "
              f"{key[:90]}", flush=True)
    if not ok:
        raise AssertionError(f"phase 13c: the secure training run failed "
                             f"its checks (equal={equal}, out={out})")
    # the recovered run's launches by row: the checkpoint's batched seal
    # and open (rows 1 and 2), the per-chunk seal and open of the batches
    # (rows 4 and 5), kernel 7 (row 7)
    cp = "ss_chacha20_cipher_pass"
    rows_launches = {
        "chacha20_cipher_pass_batch": ckpt_launches.get(cp, 0),
        "cwmac_tags": ckpt_launches.get("ss_cwmac_tags", 0),
        "chacha20_cipher_pass_message": launches[cp] - ckpt_launches.get(
            cp, 0),
        "cwmac_mac_tags": launches["ss_cwmac_mac_tags"],
        "flash_attention_fwd": launches["ss_flash_attention_fwd"],
    }
    return rows_launches, dict(steps_executed=executed,
                               kernel7_per_step=flash_per_step,
                               sec_per_step=step_s,
                               mfu=model_flops / step_s / PEAK_FLOPS,
                               model_flops=model_flops,
                               trainer_peak_memory_gb=peak / 1e9)


def phase_training(torch, dev):
    """Phase 13: 13a, 13b and 13c.  -> ({row name: launches in 13c's
    recovered run}, row 7's numbers)."""
    from repro_torch.models import api
    t0 = time.perf_counter()
    numbers = phase_train_attention(torch, dev)
    t1 = time.perf_counter()
    run = _train_run()
    params = api.init_params(run.model, torch.Generator(device=dev)
                             .manual_seed(run.seed), dev)
    phase_train_step_both_ways(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    rows_launches, more = phase_secure_training(torch, dev)
    phase("training", card=CARD, seconds=round(time.perf_counter() - t0, 3),
          attention_s=round(t1 - t0, 3), both_ways_s=round(t2 - t1, 3),
          trainer_s=round(time.perf_counter() - t2, 3))
    numbers.update(more)
    return rows_launches, numbers


# ------------------------------------------------------------------ phase 14

#: phase 14a: kernel 7's checks at the head dims phase 9 does not reach,
#: (B, H, Sq, Skv): ragged, Sq < Skv and short
FAMILY_FLASH_CHECKS = ((2, 4, 1000, 1000), (1, 3, 130, 700), (2, 4, 128, 128))
#: ... and its timed shapes, (B, H, S, D): the prefills of the configs
#: that take each head dim (granite-34b's with its one KV head expanded
#: to its 48 query heads, as ``repeat_kv`` gives it; and every config's
#: reduce_for_smoke form), and D = 32 and 96, which no config has
#: (computed at the padded widths 64 and 128), at moonshot's B, H and S
FAMILY_FLASH_TIMED = {
    "moonshot-v1-16b-a3b": (4, 16, 2048, 128),
    "qwen2.5-14b": (4, 40, 2048, 128),
    "granite-34b": (4, 48, 2048, 128),
    "internvl2-76b": (4, 64, 2048, 128),
    "kimi-k2-1t-a32b": (1, 64, 2048, 112),
    "kimi-k2-1t-a32b, 4 requests": (4, 64, 2048, 112),
    "reduce_for_smoke": (8, 4, 2048, 16),
    "no config, D = 32": (4, 16, 2048, 32),
    "no config, D = 96": (4, 16, 2048, 96),
    "no config, D = 20 (padded)": (4, 16, 2048, 20),
    "no config, D = 100 (padded)": (4, 16, 2048, 100),
    "no config, D = 192 (wide)": (4, 16, 2048, 192),
    "no config, D = 256 (wide)": (4, 16, 2048, 256),
}
#: the head dims phase 14a checks against the plain version (phase 9
#: checks 64): the configs' others, two that no config has, two whose
#: rows are not 16-byte multiples in bf16 (zero-padded to 24 and 104 by
#: the wrapper) and two above 128 (the wide kernel)
FAMILY_FLASH_DIMS = (16, 32, 96, 112, 128, 20, 100, 192, 256)
#: kernel 7 at D = 64 at phase 9's shape (8 x 32 x 4096): the most it may
#: take, ms.  Before the head-dim template it read 1.446 ms, and the
#: template's D = 64 read 1.4498-1.4699 ms in the runs of this script that
#: PERF.md section 6 records (row 7; H100 80GB HBM3, 700 W): the slowest
#: reading plus 2 %, more than that spread again
FLASH_D64_MS_LIMIT = 1.4699 * 1.02
#: phase 14's served models: requests x prompt tokens, new tokens, the
#: prompt tokens of the profiled prefill and the sLSTM timing (xlstm-125m's
#: sLSTM loop runs ~7 ms a token whatever the batch, so its full 2,048
#: would add minutes to each), and the decode continuation's prompt
#: tokens and steps (see CONTINUE_F32_TOL).  xlstm-125m's are cut for the
#: script's time limit (each 2,048-token pass took ~14 s on the H100
#: host, its profiled 256-token prefill 17 s): prompts from 2,048 tokens
#: to 512, the profile's from 256 to 128, the continuation's from 2,048
#: to 256
FAMILY_SERVE = {
    "moonshot-v1-16b-a3b": (4, 2048, 32, 2048, None),
    "zamba2-1.2b": (8, 4096, 64, 4096, (4096, 256)),
    "xlstm-125m": (8, 512, 64, 128, (256, 256)),
}
#: decode steps in each family's profile: torch.profiler's host-side
#: processing of a trace grows with its events (~0.5 ms a kernel on the
#: H100 host with the host's ops traced, most of phase 14's time at 16
#: steps: PERF.md section 4), and the steps are alike, so their busy
#: share is read from 2 (4 until phase 16 joined the script, for its
#: time limit)
FAMILY_PROFILE_STEPS = 2
#: one layer's attention output with kernel 7 against the plain attention
#: on the same input (phase 10's cache limit): bf16 rounding of each side
#: alone, where the wrong attentions move it by 0.3 and more
LAYER_ATTN_RTOL = SERVE_CACHE_RTOL
#: end to end over 38 to 48 layers (phase 10's 0.125 over 16 layers, at
#: the square root of the depth ratio, doubled): last logits
FAMILY_LOGIT_TOL = 0.25
#: the MoE model's cached keys and values, kernel 7 against plain: a token
#: routed to other experts in one run carries a different state on
FAMILY_CACHE_RTOL = 0.25
#: the prefill with kernel 7 against the plain one may differ in its
#: caches (and, for MoE, its (token, layer) top-k expert sets) at most
#: this many times as much (plus ROUTING_SLACK) as a prefill whose
#: attention differs from the plain one only in its summation order (the
#: recursive-halving "hier" schedule, exact attention too): 38-48 bf16
#: layers, and the router above all, amplify any rounding difference
#: (13.5 % of MoE sets and a 0.050 cache gap in zamba2's in the first
#: runs, PERF.md §6)
ROUTING_VS_BASELINE = 2.0
ROUTING_SLACK = 0.02
#: decode at S against prefill(S + 1), one MoE layer at a time from the
#: prefill's own input (the new token's update, attention + MoE, within
#: LAYER_ATTN_RTOL for the (request, layer) pairs routed alike): the least
#: share of pairs that must be routed alike
DECODE_ROUTED_ALIKE_MIN = 0.9
#: ... over at least this many (request, layer, position) triples: a
#: shallow MoE decodes at as many positions after S as that takes
#: (kimi-k2 at one layer and 4 requests: 16; moonshot's 48 layers: 1).
#: Its router's ~4 % of tokens whose top-8 of 384 experts lie a rounding
#: apart (the "hier" prefill against the plain one, PERF.md section 6)
#: make one flip of 4 pairs a 25 % miss (the first card run: 3 of 4)
DECODE_PAIRS_MIN = 64
#: the decode check's no-drop copy of an MoE config holds an expert
#: buffer of X · T rows of d_model (T tokens in the call): at most this
#: many bytes, else its prefill side runs a chunk of the sequence at a
#: time (kimi-k2's 384 x 8,256 x 7,168 in bf16 would be 45 GB; 272
#: positions of 4 requests are 6.0 GB, moonshot's whole 4 x 2,049 2.1 GB)
NODROP_BUFFER_BYTES = 6e9
#: phase 14d: chunked_gla on the card against its sequential oracle (f32)
GLA_TOL = (1e-4, 1e-4)
#: the decode continuation in f32 (the weights cast to f32; kernel 7's f32
#: instantiation): each of the 256 teacher-forced decode steps after
#: prefill(S) against the forward pass over the S + 256 tokens at the same
#: position, within this max abs gap (256: the forward pass's sequence
#: must stay a multiple of zamba2's and xlstm's scan chunk, 256).  zamba2-1.2b read 4.4e-4 to 9.4e-4
#: over the steps; in bf16 its 38 random layers turn rounding into gaps of
#: order 1, so bf16 is not held to it
CONTINUE_F32_TOL = 1e-2
#: xlstm-125m's random sLSTM (192 x 192 recurrent blocks at the reference's
#: scale 0.4) is chaotic: a perturbation grows ~1.15x a step (SLSTM_GROWTH
#: prints it), so any rounding difference between the prefill's and the
#: forward pass's GEMMs grows to order 1 within a few hundred tokens.  Its
#: continuation runs on a copy of the f32 weights whose r_* are scaled by
#: this factor (in this script only), under which the recurrence contracts
SLSTM_R_SCALE = 0.25
#: the sLSTM growth witness: a (2, T, d) input perturbed by EPS at its first
#: position through layer 0's sLSTM; the growth a step is the T - 1'th root
#: of the output gap's ratio between the last and the first position
SLSTM_GROWTH = (64, 1e-4)


def _no_diagonal_tile(torch, n):
    """Causal mask with each row's diagonal tile of 64 keys left out (rows
    of the first tile keep theirs): a kernel that skips its last tile."""
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    return (j <= i) & ((j < i // 64 * 64) | (i < 64))


def _wrong_attentions(torch):
    return {
        "control_no_causal_mask": _plain_bshd(
            torch, lambda n: torch.ones((n, n), dtype=torch.bool)),
        "control_no_diagonal_tile": _plain_bshd(
            torch, lambda n: _no_diagonal_tile(torch, n)),
    }


class _Routes:
    """Records the top-k expert ids of every ``moe_ffn`` call (one a
    layer, in order) by wrapping ``models.moe.route`` (in this script
    only)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.topi, self._real = [], moe.route

        def route(router, xf, k):
            out = self._real(router, xf, k)
            self.topi.append(out[2])
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real


def _hier_bshd(torch):
    """Exact causal attention in another summation order: the recursive-
    halving schedule (``models/hier_attn.py``), as kernel 7's stand-in."""
    from repro_torch.models.hier_attn import hier_causal_attention

    def attention(q, k, v, *, causal=True):
        return hier_causal_attention(q, k, v).to(q.dtype)
    return attention


def _with_attention(torch, attention, fn):
    """``fn()`` with kernel 7's wrapper replaced by ``attention`` (None:
    the kernel itself), in this script only."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    kernel = flash_ops.flash_attention
    flash_ops.flash_attention = kernel if attention is None else attention
    try:
        return fn()
    finally:
        flash_ops.flash_attention = kernel


def _rel_l2_max(torch, a, b):
    return max(((x - y).float().norm() / y.float().norm()).item()
               for x, y in zip(a, b))


def _attn_cache_layers(cache):
    return [cache["attn"][t][i] for t in ("k", "v")
            for i in range(cache["attn"]["k"].shape[0])]


def _sets_differ(torch, a, b):
    """Rows of two (T, k) expert-id arrays whose sets differ."""
    return (a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1)


def phase_flash_head_dims(torch, dev):
    """Phase 14a: kernel 7 at FAMILY_FLASH_DIMS (bf16 and f32, with and
    without the lse, head-major and through the model's (B, S, H, D)
    layout) against its plain version; each instantiation's registers,
    spills and shared memory; its time beside its bound, the plain
    version and SDPA at the configs' prefill shapes; D = 64 again at
    phase 9's shape.  -> {head dim: numbers} for row 7."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_RTOL, attention_ref, bf16_mismatch)
    from repro_torch.launch.dryrun import PEAK_FLOPS
    for (dt, D), k in sorted(flash_instantiations(
            build.ptxas_report()).items()):
        phase("flash_instance", card=CARD, dtype=dt, padded_width=D,
              registers=k["registers"], spill_stores=k["spill_stores"],
              spill_loads=k["spill_loads"],
              smem_bytes=flash_ops.smem_bytes(D) if dt != "f32"
              else "static")
    g = torch.Generator(device=dev).manual_seed(14)

    def qkv(B, H, Sq, Skv, D, dtype):
        return [torch.randn((B, H, s, D), generator=g, device=dev).to(dtype)
                for s in (Sq, Skv, Skv)]

    def run(q, k, v, causal, layout, lse):
        if layout == "bhsd":
            return flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                                  return_lse=lse)
        got = flash_ops.flash_attention(
            *(t.transpose(1, 2) for t in (q, k, v)), causal=causal,
            return_lse=lse)
        return (got[0].transpose(1, 2), got[1]) if lse \
            else got.transpose(1, 2)
    failed, numbers = [], {}
    for D in FAMILY_FLASH_DIMS:
        cases = [(sh, c) for sh in FAMILY_FLASH_CHECKS for c in (True, False)]
        cases += [((B, H, S, S), True) for B, H, S, Dt in
                  FAMILY_FLASH_TIMED.values() if Dt == D]
        for (B, H, Sq, Skv), causal in cases:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = qkv(B, H, Sq, Skv, D, dtype)
                want, want_lse = attention_ref(q, k, v, causal=causal,
                                               return_lse=True)
                errs = {}
                for layout in ("bhsd", "bshd"):
                    got, lse = run(q, k, v, causal, layout, True)
                    same = torch.equal(got, run(q, k, v, causal, layout,
                                                False))
                    lse_err = (lse - want_lse).abs().max().item()
                    if dtype == torch.float32:
                        err = (got - want).abs().max().item()
                        ok = err <= F32_TOL
                    else:
                        err, excess, row_rel = bf16_mismatch(
                            got, want, q, k, v, causal=causal)
                        ok = excess <= 0 and row_rel <= BF16_ROW_RTOL
                    ok = ok and same and lse_err <= LSE_TOL
                    errs[layout] = (err, lse_err, same, ok)
                    if not ok:
                        failed.append((D, B, H, Sq, Skv, causal, str(dtype),
                                       layout))
                del q, k, v, want, want_lse
                phase("flash_head_dim_check", card=CARD, head_dim=D,
                      dtype=str(dtype).removeprefix("torch."),
                      shape=f"{B}x{H}x{Sq}x{Skv}", causal=causal,
                      **{f"{lay}_max_abs_err": e[0] for lay, e in
                         errs.items()},
                      **{f"{lay}_lse_err": e[1] for lay, e in errs.items()},
                      lse_out_equal=all(e[2] for e in errs.values()),
                      ok=all(e[3] for e in errs.values()))
    if failed:
        raise AssertionError(f"kernel 7 differs from its plain version at "
                             f"{failed}")
    for arch, (B, H, S, D) in FAMILY_FLASH_TIMED.items():
        q, k, v = qkv(B, H, S, S, D, torch.bfloat16)
        first_ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(
            q, k, v), 20)           # printed: once read 3x the next
        ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(q, k, v),
                      20)
        lse_ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(
            q, k, v, return_lse=True), 20)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bshd_ms = eager_ms(torch, lambda: flash_ops.flash_attention(
            qs, ks, vs), 20)
        del qs, ks, vs
        plain_ms = eager_ms(torch, lambda: attention_ref(q, k, v), 2)
        library_ms = eager_ms(torch, lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  q, k, v, is_causal=True), 20)
        qf, kf, vf = q.float(), k.float(), v.float()
        f32_ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(
            qf, kf, vf), 2)
        del qf, kf, vf
        flops = flash_flops(B, H, S, S, D, True)
        b, by = bound(4 * q.numel() * q.element_size(), flops,
                      PEAK_FLOPS)
        exp2 = flash_pairs(B, H, S, S, True)
        row = dict(shape=f"B={B} H={H} S={S} D={D} bf16 causal", ms=ms,
                   first_ms=first_ms, lse_ms=lse_ms, bshd_ms=bshd_ms, plain_ms=plain_ms,
                   bound_ms=b, bound_by=by, library_ms=library_ms,
                   tflops=flops / ms / 1e9, share_of_bound=b / ms,
                   vs_library=ms / library_ms, exp2=exp2,
                   exp2_sfu_ms=exp2 / SFU_EXP2_PER_S * 1e3, f32_ms=f32_ms)
        numbers[f"D{D} {arch}"] = row
        phase("flash_head_dim_time", card=CARD, arch=arch, **row)
        del q, k, v
    B, H, S, _ = FLASH_SHAPES[0]
    q, k, v = qkv(B, H, S, S, 64, torch.bfloat16)
    ms = eager_ms(torch, lambda: flash_ops.flash_attention_bhsd(q, k, v), 20)
    numbers["D64 phase 9"] = dict(ms=ms)
    phase("flash_d64_again", card=CARD, shape=f"{B}x{H}x{S}x64", ms=ms,
          limit_ms=FLASH_D64_MS_LIMIT, ok=ms <= FLASH_D64_MS_LIMIT)
    del q, k, v
    if ms > FLASH_D64_MS_LIMIT:
        raise AssertionError(f"kernel 7 at D = 64 took {ms} ms at phase 9's "
                             f"shape, over its limit {FLASH_D64_MS_LIMIT}")
    torch.cuda.empty_cache()
    return numbers


def serve_family(torch, dev, arch, plan=None, layers=None):
    """Secure serving of ``arch`` at full width and depth (``layers``: a
    cut depth), as phase 10
    serves llama3.2-1b: weights drawn from a seed on the card, a client
    attests the enclave, FAMILY_SERVE's prompts are sealed and opened
    (MAC checked), prefilled through ``make_prefill_step`` (the time to
    first token) and generated through ``greedy_generate``; kernel 7
    launched once per attention call of each prefill and never in
    decode.  A front end's inputs come seeded in bf16 with the prompts,
    sealed and opened beside them and passed to the prefill: an audio
    model's frames (R, S, frontend_dim), added to the embeddings, a
    vision model's VISION_PATCHES patches (R, 256, frontend_dim), which
    take the first 256 positions.  ``plan``: FAMILY_SERVE's tuple for
    ``arch`` unless given.  -> (cfg, params, prompts, the front end's
    inputs {name: tensor} or {}, numbers, launches)"""
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import secure
    from repro_torch.serve.engine import (greedy_generate, make_decode_step,
                                          make_prefill_step)
    R, S, N, short, _ = plan or FAMILY_SERVE[arch]
    cfg = get_model_config(arch)
    full_depth = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, g, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in _leaves(params))
    if n != cfg.param_count():
        raise AssertionError(f"{arch}: {n} parameters drawn, the template "
                             f"has {cfg.param_count()}")
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig("serve", S, R,
                                                     "decode"))
    t0 = time.perf_counter()
    _, key, server_m = secure.attested_session(cfg.arch_id)
    attest_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (R, S), generator=g,
                            device=dev, dtype=torch.int32)
    name = FRONT_END_INPUTS.get(cfg.frontend)
    feats = None if name is None else torch.randn(
        (R, S if name == "frames" else VISION_PATCHES, cfg.frontend_dim),
        generator=g, device=dev).to(torch.bfloat16)
    max_seq = S + N
    prefill = make_prefill_step(run_cfg, max_seq=max_seq)
    secure.open_prompts(key, secure.seal_prompts(key, prompts, counter=1))
    greedy_generate(run_cfg, params, prompts[:, :256], steps=2, max_seq=257,
                    extra=None if feats is None else {
                        name: feats[:, :256]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = {}

    def serve():
        t0 = time.perf_counter()
        sealed = secure.seal_prompts(key, prompts)
        torch.cuda.synchronize()
        t["seal"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        opened = secure.open_prompts(key, sealed)
        torch.cuda.synchronize()
        t["open"] = time.perf_counter() - t0
        if not torch.equal(opened, prompts):
            raise AssertionError("opened prompts differ from the sent ones")
        extra = {}
        if feats is not None:
            got = secure.open_prompts(key, secure.seal_prompts(
                key, feats, counter=2))
            if not torch.equal(got, feats):
                raise AssertionError(f"opened {name} differ from the sent "
                                     f"ones")
            extra[name] = got
        t["after_open"] = build.launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": opened, **extra})[0]
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None].cpu()
        t["prefill"] = time.perf_counter() - t0
        t["after_prefill"] = build.launch_counts()
        t0 = time.perf_counter()
        gen = greedy_generate(run_cfg, params, opened, steps=N + 1,
                              max_seq=max_seq, extra=extra).cpu()
        t["generate"] = time.perf_counter() - t0
        return first, gen, logits, extra
    mode = "attention_free" if cfg.attention_free else "encrypted"
    (first, gen, logits, extra), launches = counted_run(
        torch, f"secure_serve {arch}", mode, serve, engine="serve")
    flash = "ss_flash_attention_fwd"
    calls = (api.num_shared_attn(cfg) if cfg.family == "hybrid"
             else 0 if cfg.attention_free else cfg.num_layers)
    in_prefill = t["after_prefill"][flash] - t["after_open"][flash]
    in_generate = {k: launches[k] - t["after_prefill"][k] for k in launches}
    if in_prefill != calls or in_generate != {
            k: calls if k == flash else 0 for k in launches}:
        raise AssertionError(
            f"{arch}: kernel 7 launched {in_prefill} times in the prefill "
            f"(want {calls}); greedy_generate launched {in_generate} (want "
            f"kernel 7 {calls} times in its prefill, none in decode)")
    if not (bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            R, cfg.vocab_size) and tuple(gen.shape) == (R, N + 1)
            and torch.equal(gen[:, :1], first) and int(gen.min()) >= 0
            and int(gen.max()) < cfg.vocab_size):
        raise AssertionError(f"{arch}: malformed logits or tokens")
    decode_s = t["generate"] - t["prefill"]
    numbers = dict(
        arch=arch, family=cfg.family, layers=f"{cfg.num_layers}/{full_depth}",
        d_model=cfg.d_model, head_dim=cfg.head_dim,
        kv_heads=cfg.num_kv_heads, params=n,
        params_bf16_gb=2 * n / 1e9, requests=R, prompt=S, new_tokens=N,
        front_end=None if feats is None else
        f"{name} " + "x".join(map(str, feats.shape)),
        init_params_s=init_s, init_peak_memory_gb=init_peak / 1e9,
        attest_s=attest_s, measurement=server_m.hex()[:16],
        seal_ms=t["seal"] * 1e3, open_ms=t["open"] * 1e3, mac_ok=True,
        prefill_s=t["prefill"], prefill_tokens_per_s=R * S / t["prefill"],
        ttft_ms=(t["open"] + t["prefill"]) * 1e3, generate_s=t["generate"],
        decode_ms_per_step=decode_s / N * 1e3,
        decode_tokens_per_s=R * N / decode_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_launches_prefill=in_prefill)
    phase("family_serve", card=CARD, **numbers)
    print(f"   generated req0: {gen[0, :12].tolist()} ...", flush=True)
    t0 = time.perf_counter()
    shares = phase_serve_profile(torch, cfg, params, prompts[:, :short],
                                 prefill, make_decode_step(run_cfg),
                                 steps=FAMILY_PROFILE_STEPS,
                                 extra=_front_end(torch, extra, short))
    numbers.update(prefill_busy_share=shares.get("prefill"),
                   decode_busy_share=shares.get("decode"),
                   profile_s=time.perf_counter() - t0)
    return cfg, params, prompts, extra, numbers, launches


def _front_end(torch, extra, n):
    """A front end's inputs for the first ``n`` prompt tokens: frames cut
    to ``n``, patches as they are (they take the first 256 positions).
    ``n`` past the prompt pads the frames with zero rows: a token decoded
    there has no frame (its embedding alone)."""
    out = dict(extra)
    if "frames" in out:
        f = out["frames"]
        out["frames"] = f[:, :n] if n <= f.shape[1] else \
            torch.nn.functional.pad(f, (0, 0, 0, n - f.shape[1]))
    return out


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    return [tree]


def layerwise_attention(torch, cfg, params, tokens, attentions, extra=None):
    """Walk the model with the plain attention; at every attention call
    feed the same normed input to ``mha`` under each of ``attentions``
    (None: kernel 7) and to the plain one, and compare the outputs.
    ``extra``: a front end's inputs.  -> {name: largest relative L2
    difference over the calls}"""
    from repro_torch.models import api, mamba2 as M2
    from repro_torch.models import layers as L
    plain = _plain_bshd(torch)
    x = api._embed(cfg, params, {"tokens": tokens, **(extra or {})})
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    worst = {name: 0.0 for name in attentions}

    def attend(p, x):
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)

        def mha():
            return L.mha(p["attn"], h, cfg, positions=pos,
                         attn_impl="pallas_flash")
        ref = _with_attention(torch, plain, mha)
        for name, attention in attentions.items():
            out = _with_attention(torch, attention, mha)
            worst[name] = max(worst[name], _rel_l2_max(torch, [out], [ref]))
        return api._ffn_residual(p, x + ref, cfg)[0]
    if cfg.family == "hybrid":
        for start, size, has_attn in api._hybrid_groups(cfg):
            for i in range(start, start + size):
                p = L.layer(params["layers"], i)
                x = x + M2.mamba2_forward(
                    p["mamba"], L.rms_norm(x, p["ln"], cfg.rms_eps), cfg)
            if has_attn:
                x = attend(params["shared_attn"], x)
    else:
        for i in range(cfg.num_layers):
            x = attend(L.layer(params["layers"], i), x)
    return worst


def kernel_vs_plain(torch, cfg, params, tokens, extra=None):
    """The prefill with kernel 7 against the same prefill with the plain
    attention in its place (last logits, every attention layer's cached
    keys and values; for MoE, every layer's top-k expert sets, beside a
    prefill with the "hier" attention as the baseline of rounding
    differences), then layer by layer with the kernel and the two wrong
    attentions; ``extra``: a front end's inputs for ``tokens``.  ->
    numbers; raises when a limit is missed or a wrong attention meets the
    layer limit."""
    from repro_torch.models import api
    S = tokens.shape[1]
    batch = {"tokens": tokens, **(extra or {})}

    def prefill():
        with _Routes() as r:
            logits, cache = api.prefill(cfg, params, batch)
        return logits, _attn_cache_layers(cache), r.topi
    lp, cp, rp = _with_attention(torch, _plain_bshd(torch), prefill)
    lk, ck, rk = _with_attention(torch, None, prefill)
    out = dict(logits_max_abs=(lk - lp).abs().max().item(),
               logits_std=lp.std().item(),
               cache_rel_l2=_rel_l2_max(torch, ck, cp))
    del ck
    lh, ch, rh = _with_attention(torch, _hier_bshd(torch), prefill)
    out["hier_cache_rel_l2"] = _rel_l2_max(torch, ch, cp)
    out["hier_logits_max_abs"] = (lh - lp).abs().max().item()
    del ch
    last_agrees = True
    if rk:
        for name, r in (("", rk), ("hier_", rh)):
            differ = [_sets_differ(torch, a, b) for a, b in zip(r, rp)]
            shares = [float(d.float().mean()) for d in differ]
            out[f"{name}routing_sets_differ_share"] = sum(shares) / len(
                shares)
            out[f"{name}routing_share_by_layer"] = _by_layer(shares)
            if not name:
                last_agrees = not any(bool(d.view(-1, S)[:, -1].any())
                                      for d in differ)
        out["last_token_routing_agrees"] = last_agrees
    del cp
    layer = layerwise_attention(torch, cfg, params, tokens, dict(
        kernel=None, hier=_hier_bshd(torch), **_wrong_attentions(torch)),
        extra)
    out.update({f"layer_rel_l2_{k}": v for k, v in layer.items()})
    ok = (layer["kernel"] <= LAYER_ATTN_RTOL
          and all(v > LAYER_ATTN_RTOL for k, v in layer.items()
                  if k.startswith("control")))
    ok = ok and out["cache_rel_l2"] <= min(
        FAMILY_CACHE_RTOL,
        ROUTING_VS_BASELINE * out["hier_cache_rel_l2"] + ROUTING_SLACK) \
        and (not last_agrees or out["logits_max_abs"] <= FAMILY_LOGIT_TOL)
    if rk:
        ok = ok and out["routing_sets_differ_share"] <= (
            ROUTING_VS_BASELINE * out["hier_routing_sets_differ_share"]
            + ROUTING_SLACK)
    phase("family_kernel_vs_plain", card=CARD, arch=cfg.arch_id,
          tokens="x".join(map(str, tokens.shape)), layer_rtol=LAYER_ATTN_RTOL,
          logit_tol=FAMILY_LOGIT_TOL, routing_vs_baseline=ROUTING_VS_BASELINE,
          routing_slack=ROUTING_SLACK, **out, ok=ok)
    if not ok:
        raise AssertionError(f"{cfg.arch_id}: kernel 7 against the plain "
                             f"attention: {out}")
    return out


def _by_layer(xs) -> str:
    """Layers 0, 1, L // 2 and L - 1 of a per-layer list (those there are),
    "/"-joined."""
    n = len(xs)
    return "/".join(f"{xs[i]:.4f}" for i in sorted({0, 1, n // 2, n - 1})
                    if i < n)


def decode_layerwise(torch, cfg, params, tokens, extra=None, steps=1,
                     chunk=None):
    """Decode at positions S .. S + ``steps`` - 1 against prefill(S +
    ``steps``) of ``tokens`` (B, S + steps; ``extra``: a front end's inputs
    for them), one layer at a time: each layer's prefill over all the
    tokens (kernel 7) from the prefill's own input, and the decode step's
    layer (``mha_decode`` over the prefill's first S keys and values and
    the decoded ones since, the MoE at T = B) on each position's input;
    the two updates of the token compared for the requests whose token is
    routed alike in both.  ``chunk``: the prefill's FFN runs over the last
    ``chunk`` positions of every request at a time, the decoded ones in
    the last chunk: where the capacity drops nothing, each token's MoE
    update is the one the whole call gives it, at an expert buffer of B ·
    ``chunk`` rows.  -> (largest relative L2 of the compared updates,
    (request, layer, position) triples routed alike, triples)"""
    from repro_torch.models import api
    from repro_torch.models import layers as L
    B, S1 = tokens.shape
    S = S1 - steps
    W = min(chunk or S1, S1)
    assert W >= steps, (W, steps)
    x = api._embed(cfg, params, {"tokens": tokens, **(extra or {})})
    pos = torch.arange(S1, dtype=torch.int32, device=x.device)[None].expand(
        B, S1)
    worst, alike, pairs = 0.0, 0, 0
    for i in range(cfg.num_layers):
        p = L.layer(params["layers"], i)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        att, (k, v) = L.mha(p["attn"], h, cfg, positions=pos,
                            attn_impl="pallas_flash", return_kv=True)
        ys = []
        for end in range(S1, 0, -W):
            with _Routes() as r:
                ys.append(api._ffn_residual(p, (x + att)[:, max(
                    0, end - W):end], cfg)[0])
            if end == S1:
                rp = r
        y = torch.cat(ys[::-1], dim=1)
        del ys
        cache = {"k": torch.zeros_like(k), "v": torch.zeros_like(v)}
        cache["k"][:, :S], cache["v"][:, :S] = k[:, :S], v[:, :S]
        for t in range(S, S1):
            xs = x[:, t:t + 1]
            with _Routes() as rd:
                att1, _ = L.mha_decode(p["attn"], L.rms_norm(
                    xs, p["ln1"], cfg.rms_eps), cache, cfg, pos=t)
                y1 = api._ffn_residual(p, xs + att1, cfg)[0]
            same = ~_sets_differ(torch, rd.topi[0], rp.topi[0].view(
                B, W, -1)[:, t - S1 + W]) if rd.topi \
                else torch.ones(B, dtype=torch.bool, device=x.device)
            alike += int(same.sum())
            pairs += B
            got = (y1[:, 0] - xs[:, 0]).float()
            want = (y[:, t] - xs[:, 0]).float()
            rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
            if bool(same.any()):
                worst = max(worst, float(rel[same].max()))
        x = y
    return worst, alike, pairs


def continuation(torch, cfg, params, prompts, g, steps):
    """prefill(S), then ``steps`` teacher-forced decode steps, each step's
    logits against the forward pass over the S + ``steps`` tokens at the
    same position (the prefill's function at every position).  -> the
    max abs gap of each step's logits (a list)"""
    from repro_torch.models import api
    B, S = prompts.shape
    cont = torch.randint(0, cfg.vocab_size, (B, steps), generator=g,
                         device=prompts.device, dtype=torch.int32)
    hidden, _ = api.forward(cfg, params, {"tokens": torch.cat(
        [prompts, cont], dim=1)}, remat="none", attn_impl="pallas_flash")
    w = api._lm_head_weight(cfg, params)
    _, cache = api.prefill(cfg, params, {"tokens": prompts},
                           max_seq=S + steps)
    gaps = []
    for j in range(steps):
        logits, cache = api.decode_step(cfg, params, cont[:, j:j + 1],
                                        S + j, cache)
        gaps.append((logits - api._logits(hidden[:, S + j], w)).abs().max())
    return torch.stack(gaps).tolist()


def decode_vs_prefill(torch, cfg, params, prompts, extra=None, steps=1,
                      layer_cfg=None, chunk=None):
    """Decode at position S (after prefill(S) of ``prompts``, its greedy
    token) against prefill(S + 1) of the prompts and that token: the last
    logits' max abs gap; and layer by layer (:func:`decode_layerwise`, on
    ``layer_cfg`` if given, its FFN ``chunk`` positions at a time) at
    ``steps`` positions, the greedy token and ``steps`` - 1 seeded ones
    after it.  ``extra``: a front end's inputs for the prompts (a decoded
    token has none: a zero frame in the prefill).  -> numbers"""
    from repro_torch.models import api
    B, S = prompts.shape
    extra = extra or {}
    logits, cache = api.prefill(cfg, params, {"tokens": prompts, **extra},
                                max_seq=S + 1)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    logits_d, _ = api.decode_step(cfg, params, tok, S, cache)
    del cache
    full = torch.cat([prompts, tok], dim=1)
    logits_p = api.prefill(cfg, params, {
        "tokens": full, **_front_end(torch, extra, S + 1)})[0]
    cont = torch.randint(0, cfg.vocab_size, (B, steps - 1), device=full.device,
                         dtype=torch.int32, generator=torch.Generator(
                             device=full.device).manual_seed(8))
    full = torch.cat([full, cont], dim=1)
    layer_err, alike, pairs = decode_layerwise(
        torch, layer_cfg or cfg, params, full,
        _front_end(torch, extra, S + steps), steps, chunk)
    return dict(decode_vs_prefill_max_abs=(logits_d - logits_p).abs().max()
                .item(), decode_layer_rel_l2=layer_err,
                decode_routed_alike=alike / pairs, decode_positions=steps,
                decode_pairs=pairs, requests=B)


def nodrop_chunk(cfg, B: int, S1: int) -> int:
    """The positions of B requests whose no-drop MoE call holds an expert
    buffer of at most NODROP_BUFFER_BYTES (S1 where the whole fits)."""
    row = cfg.moe.num_experts * B * cfg.d_model * 2
    return max(1, min(S1, int(NODROP_BUFFER_BYTES // row)))


def phase_moe_checks(torch, cfg, params, prompts, extra=None):
    """Phase 14b's checks (and kimi-k2's in 17): the share of assignments
    the real capacity drops in the served prefill; kernel 7 against plain
    at 1 x S; decode at position S against prefill(S + 1) layer by layer
    on a copy of the config whose capacity drops nothing (capacity factor
    X / k), at least DECODE_ROUTED_ALIKE_MIN of the (request, layer)
    pairs routed alike.  Where that copy's expert buffer over the whole
    prefill exceeds NODROP_BUFFER_BYTES (kimi-k2), its FFN runs over
    chunks of the sequence that fit, and the whole model's prefill(S + 1)
    (its last logits' gap, printed) on the served config.  ``extra``: a
    front end's inputs."""
    from repro_torch.models import api
    from repro_torch.models.moe import _capacity
    B, S = prompts.shape
    moe = cfg.moe
    extra = extra or {}
    with _Routes() as r:
        api.prefill(cfg, params, {"tokens": prompts, **extra})
    C = _capacity(B * S, moe.top_k, moe.num_experts, moe.capacity_factor)
    dropped = [int((torch.bincount(t.reshape(-1), minlength=moe.num_experts)
                    - C).clamp_min(0).sum()) / (B * S * moe.top_k)
               for t in r.topi]
    drop_share = sum(dropped) / len(dropped)
    del r
    out = dict(capacity=C, dropped_share=drop_share,
               dropped_share_by_layer=_by_layer(dropped))
    out.update(kernel_vs_plain(torch, cfg, params, prompts[:1],
                               {k: v[:1] for k, v in extra.items()}))
    steps = -(-DECODE_PAIRS_MIN // (B * cfg.num_layers))
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    chunk = nodrop_chunk(cfg, B, S + steps)
    out.update(decode_vs_prefill(
        torch, nodrop if chunk == S + steps else cfg, params, prompts, extra,
        steps, layer_cfg=nodrop, chunk=chunk),
        nodrop_capacity_factor=nodrop.moe.capacity_factor,
        nodrop_chunk=chunk)
    layer_err, alike = out["decode_layer_rel_l2"], out["decode_routed_alike"]
    ok = layer_err <= LAYER_ATTN_RTOL and alike >= DECODE_ROUTED_ALIKE_MIN
    phase("moe_decode_check", card=CARD, arch=cfg.arch_id,
          layer_rtol=LAYER_ATTN_RTOL, alike_min=DECODE_ROUTED_ALIKE_MIN,
          capacity=C, dropped_share=drop_share,
          dropped_share_by_layer=out["dropped_share_by_layer"],
          **{k: out[k] for k in ("decode_vs_prefill_max_abs",
                                 "decode_layer_rel_l2", "decode_routed_alike",
                                 "decode_positions", "decode_pairs",
                                 "requests", "nodrop_capacity_factor",
                                 "nodrop_chunk")},
          ok=ok)
    if not ok:
        raise AssertionError(f"{cfg.arch_id}: decode at S against "
                             f"prefill(S + 1): {out}")
    return out


def phase_xlstm_checks(torch, dev, cfg, params, prompts, short):
    """Phase 14d's own checks: the port's chunked_gla on the card against
    its sequential oracle at one mLSTM layer's shape (f32), and the sLSTM
    loop's share of a prefill (timed with a sync around each call)."""
    from repro_torch.models import api, gla
    from repro_torch.models import xlstm as XL
    g = torch.Generator(device=dev).manual_seed(4)
    dp, H, dh = XL._mlstm_dims(cfg)
    B, S = 2, prompts.shape[1]
    q, k, v = (torch.randn((B, S, H, dh), generator=g, device=dev) * 0.1
               for _ in range(3))
    log_f = torch.nn.functional.logsigmoid(
        torch.randn((B, S, H), generator=g, device=dev) + 3)
    i_gate = torch.sigmoid(torch.randn((B, S, H), generator=g, device=dev))
    got = gla.chunked_gla(q, k, v, log_f, i_gate,
                          chunk=cfg.xlstm.chunk_size, normalize=True)
    want = gla.gla_reference(q, k, v, log_f, i_gate, normalize=True)
    excess = ((got - want).abs() - GLA_TOL[0] - GLA_TOL[1] * want.abs()
              ).max().item()
    gla_err = (got - want).abs().max().item()
    del q, k, v, got, want
    real = XL.slstm_forward_with_state
    spent = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out
    XL.slstm_forward_with_state = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(cfg, params, {"tokens": prompts[:, :short]})
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        XL.slstm_forward_with_state = real
    out = dict(gla_shape=f"{B}x{S}x{H}x{dh}", gla_max_abs_err=gla_err,
               gla_tol=GLA_TOL, slstm_s=sum(spent), prefill_s=total,
               slstm_share=sum(spent) / total, slstm_layers=len(spent),
               slstm_prefill_tokens=f"{prompts.shape[0]}x{short}")
    phase("xlstm_check", card=CARD, **out, ok=excess <= 0)
    if excess > 0:
        raise AssertionError(f"chunked_gla differs from gla_reference on "
                             f"the card: {out}")
    return out


def slstm_growth(torch, dev, cfg, p):
    """SLSTM_GROWTH's witness on layer 0's sLSTM of the weights ``p``: ->
    the growth a step of a perturbation of the input's first position."""
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as XL
    T, eps = SLSTM_GROWTH
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, T, cfg.d_model), generator=g, device=dev)
    dx = torch.zeros_like(x)
    dx[:, 0] = eps * torch.randn((2, cfg.d_model), generator=g, device=dev)
    sl = L.layer(p["layers"], 0)["slstm"]
    gap = (XL.slstm_forward(sl, x + dx, cfg) - XL.slstm_forward(sl, x, cfg)
           ).abs().amax(dim=(0, 2))
    return float((gap[-1] / gap[0]) ** (1 / (T - 1)))


def family_continuation(torch, dev, cfg, params, prompts):
    """Phase 14c/d's decode continuation in f32 (CONTINUE_F32_TOL), for
    xlstm-125m on its contracting copy (SLSTM_R_SCALE, with the growth a
    step of the real and the scaled sLSTM).  -> numbers; raises when a
    step misses the limit or the scaled sLSTM does not contract."""
    cont_prompt, cont_steps = FAMILY_SERVE[cfg.arch_id][4]
    p = _as_f32(params)
    out = {}
    if cfg.family == "ssm":
        out["slstm_growth_real"] = slstm_growth(torch, dev, cfg, p)
        sl = p["layers"]["slstm"]
        for g in "zifo":
            sl[f"r_{g}"] = sl[f"r_{g}"] * SLSTM_R_SCALE
        out.update(slstm_r_scale=SLSTM_R_SCALE,
                   slstm_growth_scaled=slstm_growth(torch, dev, cfg, p))
    gaps = continuation(torch, cfg, p, prompts[:2, :cont_prompt],
                        torch.Generator(device=dev).manual_seed(5),
                        cont_steps)
    del p
    worst = max(gaps)
    out.update(continue_f32_max_abs=worst,
               continue_f32_worst_step=gaps.index(worst),
               **{f"continue_f32_step{j}": gaps[j]
                  for j in (0, 15, 63, cont_steps - 1)})
    ok = worst <= CONTINUE_F32_TOL and out.get("slstm_growth_scaled",
                                                0.0) < 1.0
    phase("family_continue", card=CARD, arch=cfg.arch_id, steps=cont_steps,
          requests=2, prompt=cont_prompt, f32_tol=CONTINUE_F32_TOL, **out,
          ok=ok)
    if not ok:
        raise AssertionError(f"{cfg.arch_id}: the decode steps after "
                             f"prefill(S) against the forward pass in f32 "
                             f"(or the scaled sLSTM's growth): {out}")
    return out


def phase_families(torch, dev):
    """Phase 14: kernel 7's head dims, then moonshot-v1-16b-a3b,
    zamba2-1.2b and xlstm-125m served at full width and depth, each
    checked.  -> (row 7's per-head-dim numbers, {arch: kernel 7 launches
    in its serving run}, {arch: numbers})"""
    t0 = time.perf_counter()
    phase("families_start", card=CARD,
          allocated_gb=torch.cuda.memory_allocated() / 1e9)
    head_dims = phase_flash_head_dims(torch, dev)
    launches, numbers = {}, {}
    for arch in FAMILY_SERVE:
        t1 = time.perf_counter()
        cfg, params, prompts, _, nums, ran = serve_family(torch, dev, arch)
        launches[arch] = ran["ss_flash_attention_fwd"]
        nums["serve_s"] = time.perf_counter() - t1
        if cfg.family == "moe":
            nums.update(phase_moe_checks(torch, cfg, params, prompts))
        elif cfg.family == "hybrid":
            nums.update(kernel_vs_plain(torch, cfg, params, prompts[:1]))
        else:
            nums.update(phase_xlstm_checks(torch, dev, cfg, params, prompts,
                                           FAMILY_SERVE[arch][3]))
        nums["checks_s"] = time.perf_counter() - t1 - nums["serve_s"]
        if cfg.family != "moe":
            t2 = time.perf_counter()
            nums.update(family_continuation(torch, dev, cfg, params,
                                            prompts))
            nums["continue_s"] = time.perf_counter() - t2
        nums["seconds"] = time.perf_counter() - t1
        numbers[arch] = nums
        del params, prompts
        gc.collect()
        torch.cuda.empty_cache()
    phase("families", card=CARD, seconds=round(time.perf_counter() - t0, 3),
          **{f"{a}_{k}": round(n[k], 3) for a, n in numbers.items()
             for k in ("seconds", "serve_s", "profile_s", "checks_s",
                       "continue_s") if k in n})
    return head_dims, launches, numbers


# ------------------------------------------------------------------ phase 15

#: the dry run's peak estimate against the measured peak of the same step
#: on the card (15a's train step, 15b's prefill): within this share either
#: way.  Stated before the first card run (PERF.md section 6, PR 21)
DRYRUN_PEAK_BAND = 0.25
#: the dry run's exact terms against the card's count (FLOPs by formula)
DRYRUN_FLOP_RTOL = 1e-9
#: records of phase 15's dry-run cells (the ignored build directory)
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "phase15_dryrun"
#: 15b: qwen2.5-14b served at full width and depth: requests x prompt
#: tokens, new tokens, the profiled prefill's prompt tokens (as
#: FAMILY_SERVE)
QWEN_ARCH = "qwen2.5-14b"
QWEN_SERVE = (4, 2048, 32, 2048, None)


def _norm_params(cfg) -> int:
    """Parameters that take part in no matrix product: the norms' gains
    (every leaf named ``ln*``, ``*norm*``)."""
    from repro_torch.models import api
    from repro_torch.models.layers import ParamSpec

    def walk(t, name=""):
        if isinstance(t, ParamSpec):
            return math.prod(t.shape) if ("ln" in name or "norm" in name) \
                else 0
        return sum(walk(v, k) for k, v in t.items())
    return walk(api.param_template(cfg))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _measured_peak(torch, args_bytes: int, fn):
    """``fn()`` with the allocator's peak reset: -> (result, seconds, its
    peak less whatever else is alive that is not one of its arguments,
    which the dry run counts as ``args_bytes``)."""
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - args_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - other


def _peak_ok(est: int, got: int) -> bool:
    return abs(est - got) <= DRYRUN_PEAK_BAND * got


def phase_dryrun_training(torch, dev, train_numbers):
    """Phase 15a: the dry run of llama3.2-1b's train step at phase 13's
    shape, remat and optimizer beside that step on the card.  -> numbers"""
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.train.steps import make_train_step
    run = _train_run()
    cfg = run.model
    t0 = time.perf_counter()
    rec = dryrun.run_cell(TRAIN_ARCH, "train_4k", out_dir=str(DRYRUN_DIR),
                          force=True, overrides=dict(shape=run.shape,
                                                     remat=run.remat))
    if rec["status"] != "ok":
        raise AssertionError(f"phase 15a: the dry run failed: {rec}")
    none, _ = dryrun.trace_cell(dataclasses.replace(run, remat="none"))
    trace_s = time.perf_counter() - t0
    # the same step on the card, from seeded weights and phase 13's data
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        run.seed), dev)
    step_fn, opt = make_train_step(run)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             train_data_fn(cfg.vocab_size)(0).items()}
    warm = step_fn(params, state, batch, 0)               # warm-up
    del warm
    gc.collect()
    args = _tree_bytes(params) + _tree_bytes(state) + _tree_bytes(batch)
    (out, step_s, peak), launches = counted_run(
        torch, "dryrun_train_step", "flash",
        lambda: _measured_peak(torch, args, lambda: step_fn(
            params, state, batch, 0)), engine="train_step")
    loss = float(out[2]["loss"])
    del out, params, state, batch
    torch.cuda.empty_cache()
    r, m = rec["roofline"], rec["memory"]
    B, S, L = run.shape.global_batch, run.shape.seq_len, cfg.num_layers
    ff = flash_flops(B, cfg.num_heads, S, S, cfg.head_dim, True)
    T = B * S
    n, n_norm = cfg.param_count(), _norm_params(cfg)
    k7 = rec["flops_by_op"].get("repro_torch.flash_attention_fwd", 0.0)
    k7_card = launches["ss_flash_attention_fwd"] * ff
    # phase 13's model FLOPs, 6 N T + 3 L ff, term by term: the weight
    # products (the norms' gains take part in none), kernel 7 (the same
    # formula as the card's count), its backward counted as 2 L ff there
    model13 = 6 * n * T + 3 * L * ff
    dense_none = none.flops_by_op.get("aten.mm", 0.0)
    k7_none = none.flops_by_op.get("repro_torch.flash_attention_fwd", 0.0)
    terms = dict(
        dense_products=(dense_none, 6 * (n - n_norm) * T),
        kernel7_forward=(k7_none, L * ff),
        kernel7_remat_full=(k7, k7_card))
    flops_ok = all(abs(a - b) <= DRYRUN_FLOP_RTOL * b for a, b in
                   terms.values())
    peak_ok = _peak_ok(m["peak_estimate_bytes"], peak)
    numbers = dict(
        arch=TRAIN_ARCH, batch=B, seq=S, remat=run.remat,
        optimizer=run.optimizer.name, trace_s=trace_s,
        model_flops_per_chip=r["model_flops_per_chip"],
        counted_flops=r["hlo_flops_per_chip"],
        counted_flops_remat_none=none.flops,
        flops_by_op="/".join(f"{k}:{v:.6e}" for k, v in
                             sorted(rec["flops_by_op"].items())),
        kernel8_flops_remat_none=none.flops_by_op.get(
            "repro_torch.flash_attention_bwd", 0.0),
        phase13_backward_as_2x_forward=2 * L * ff,
        phase13_model_flops=model13,
        counted_over_phase13=r["hlo_flops_per_chip"] / model13,
        **{f"{k}_dryrun": a for k, (a, _) in terms.items()},
        **{f"{k}_formula": b for k, (_, b) in terms.items()},
        norm_params=n_norm,
        peak_estimate_gb=m["peak_estimate_bytes"] / 1e9,
        argument_gb=m["argument_bytes"] / 1e9,
        t_compute_s=r["t_compute_s"], t_mem_s=r["t_mem_s"],
        roofline_fraction=r["roofline_fraction"],
        measured_step_s=step_s, measured_peak_gb=peak / 1e9,
        measured_args_gb=args / 1e9, loss=loss,
        measured_mfu=model13 / step_s / dryrun.PEAK_FLOPS,
        step_over_t_compute=step_s / r["t_compute_s"],
        kernel7_launches=launches["ss_flash_attention_fwd"],
        phase13_sec_per_step=train_numbers.get("sec_per_step"),
        phase13_mfu=train_numbers.get("mfu"),
        phase13_trainer_peak_gb=train_numbers.get("trainer_peak_memory_gb"),
        peak_band=DRYRUN_PEAK_BAND,
        peak_estimate_over_measured=m["peak_estimate_bytes"] / peak,
        flops_ok=flops_ok, peak_ok=peak_ok)
    phase("dryrun_train", card=CARD, **numbers)
    if not (flops_ok and peak_ok and math.isfinite(loss)):
        raise AssertionError(f"phase 15a: the dry run against the card: "
                             f"{numbers}")
    return numbers


def _dryrun_shape(arch, shape, S, B, kind, model=None):
    """The dry run's record of ``arch``'s ``shape`` cell at B x S
    (``model``: a cut config in the arch's place)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, out_dir=str(DRYRUN_DIR), force=True,
                          overrides=dict(shape=ShapeConfig(shape, S, B, kind),
                                         **({} if model is None else
                                            {"model": model})))
    if rec["status"] != "ok":
        raise AssertionError(f"the dry run of {arch} {shape} failed: "
                             f"{rec}")
    return rec


def phase_qwen_serve(torch, dev):
    """Phase 15b: qwen2.5-14b served at full width and depth.  ->
    (kernel 7 launches, numbers)"""
    return phase_full_serve(torch, dev, QWEN_ARCH, QWEN_SERVE, "qwen_serve")


def phase_full_serve(torch, dev, arch, plan, tag, layers=None,
                     records=None):
    """``arch`` served at full width and depth (``layers``: a cut depth;
    as phase 14 serves its families; a front end's inputs sealed beside
    the prompts), checked as moonshot is (kernel 7 against the plain
    attention end to end and layer by layer at 1 x S, decode at S against
    prefill(S + 1) layer by layer, both with the front end's inputs; an
    MoE by :func:`phase_moe_checks`), beside the dry run's prefill and
    decode records at the served shape (``records``: those of the plan,
    else traced here).  -> (kernel 7 launches, numbers)"""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.dryrun import input_specs
    from repro_torch.serve.engine import make_prefill_step
    R, S, N, _, _ = plan
    t0 = time.perf_counter()
    cfg, params, prompts, extra, nums, ran = serve_family(
        torch, dev, arch, plan, layers)
    nums["serve_s"] = time.perf_counter() - t0
    pre, dec = records or (
        _dryrun_shape(arch, "prefill_32k", S, R, "prefill"),
        _dryrun_shape(arch, "decode_32k", S + N, R, "decode"))
    # the dry run's prefill on the card: max_seq S, the params and the
    # prompts (with a front end's opened inputs, as its input specs) its
    # arguments
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill_32k", S, R,
                                                 "prefill"))
    prefill = make_prefill_step(run, max_seq=S)
    batch = {k: prompts if k == "tokens" else extra[k]
             for k in input_specs(run)}
    args = _tree_bytes(batch) + _tree_bytes(params)
    (logits, _), prefill_s, peak = _measured_peak(
        torch, args, lambda: prefill(params, batch))
    del logits, batch
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    if cfg.family == "moe":
        nums.update(phase_moe_checks(torch, cfg, params, prompts, extra))
    else:
        nums.update(kernel_vs_plain(torch, cfg, params, prompts[:1],
                                    {k: v[:1] for k, v in extra.items()}))
        nums.update(decode_vs_prefill(torch, cfg, params, prompts, extra))
    nums["checks_s"] = time.perf_counter() - t1
    peak_ok = _peak_ok(pre["memory"]["peak_estimate_bytes"], peak)
    decode_ok = nums["decode_layer_rel_l2"] <= LAYER_ATTN_RTOL and \
        nums["decode_routed_alike"] >= (DECODE_ROUTED_ALIKE_MIN
                                        if cfg.family == "moe" else 1.0)
    rp, rd = pre["roofline"], dec["roofline"]
    nums.update(
        dryrun_prefill_trace_s=pre["lower_s"],
        dryrun_prefill_counted_flops=rp["hlo_flops_per_chip"],
        dryrun_prefill_t_compute_s=rp["t_compute_s"],
        dryrun_prefill_t_mem_s=rp["t_mem_s"],
        dryrun_prefill_peak_gb=pre["memory"]["peak_estimate_bytes"] / 1e9,
        dryrun_prefill_fits_one_card=pre["fits_one_card"],
        measured_prefill_s=prefill_s, measured_prefill_peak_gb=peak / 1e9,
        prefill_s_over_t_compute=prefill_s / rp["t_compute_s"],
        peak_estimate_over_measured=pre["memory"]["peak_estimate_bytes"]
        / peak,
        dryrun_decode_t_compute_s=rd["t_compute_s"],
        dryrun_decode_t_mem_s=rd["t_mem_s"],
        dryrun_decode_peak_gb=dec["memory"]["peak_estimate_bytes"] / 1e9,
        decode_ms_over_t_mem=nums["decode_ms_per_step"] / 1e3
        / rd["t_mem_s"],
        peak_band=DRYRUN_PEAK_BAND, peak_ok=peak_ok, decode_ok=decode_ok,
        seconds=time.perf_counter() - t0)
    phase(tag, card=CARD, **{k: v for k, v in nums.items()
                             if not isinstance(v, dict)})
    del params, prompts, extra
    gc.collect()
    torch.cuda.empty_cache()
    if not (peak_ok and decode_ok):
        raise AssertionError(f"{tag}: {arch}: {nums}")
    return ran["ss_flash_attention_fwd"], nums


def phase_dryrun(torch, dev, train_numbers):
    """Phase 15: 15a and 15b.  -> (kernel 7 launches in 15b's serving run,
    {"train": 15a's numbers, "qwen": 15b's})"""
    t0 = time.perf_counter()
    train = phase_dryrun_training(torch, dev, train_numbers)
    t1 = time.perf_counter()
    launches, qwen = phase_qwen_serve(torch, dev)
    phase("dryrun", card=CARD, seconds=round(time.perf_counter() - t0, 3),
          train_s=round(t1 - t0, 3), qwen_s=round(time.perf_counter() - t1,
                                                   3))
    return launches, {"train": train, "qwen": qwen}


# ------------------------------------------------------------------ phase 16

#: phase 16: the other families' train steps on the card, seeded weights
#: drawn there at full width and depth: batch x sequence, remat and the
#: timed steps.  xlstm-125m's sLSTM is a
#: per-token Python loop under autograd (~1 ms a layer a token on the H100
#: host, PERF.md section 5), so its sequence is cut to 256 and it trains
#: at remat "none" (its activations are small; "full" would run the loop
#: a third time); moonshot's 48 layers of 64 experts (28 B parameters,
#: over 300 GB with AdamW) are cut to MOE_TRAIN_LAYERS
FAMILY_TRAIN = {
    "zamba2-1.2b": (4, 2048, "full", 3),
    "xlstm-125m": (4, 256, "none", 3),
    "moonshot-v1-16b-a3b": (2, 2048, "full", 3),
    "musicgen-large": (2, 2048, "full", 1),
}
#: moonshot's depth on one card: 4 layers, or 2 if the dry run's peak
#: estimate at 4 is over MOE_TRAIN_PEAK_LIMIT bytes
MOE_TRAIN_LAYERS = (4, 2)
MOE_TRAIN_PEAK_LIMIT = 60e9
#: 16b: xlstm-125m's Trainer run: its sequence (cut from the timed steps'
#: 256 for the script's time limit: the two runs take 13 steps, ~6.5 s
#: each at 256 and 1.6-2.5 s at 64 on the H100 hosts), steps, checkpoint
#: cadence and the step of the injected failure (after the first
#: checkpoint)
XLSTM_TRAINER = (32, 6, 2, 3)
FAMILY_CKPT_DIR = Path(__file__).resolve().parent / "build" / "phase16_ckpt"
#: 16, kernel 7 against the plain attention in training, at 1 x S from the
#: same weights and batch: the gradients of a step with kernel 7
#: ("flash") and with the plain "chunked" attention, all leaves as one
#: vector.  In f32 the two differ in attention's forward (kernel 7's f32
#: kernel, ~1e-6 from the plain one) and the order of the backward's
#: sums: within FAMILY_GRAD_F32_RTOL relative L2 (a wrong backward or
#: forward moves them by O(1e-1)); in bf16 every product rounds, so the
#: flash step's gradients may be no farther from the f32 chunked step's
#: than FAMILY_GRAD_BF16_RATIO times the bf16 chunked step's are (phase
#: 13b's rule for llama's attention leaves).  The MoE router may route a
#: token whose top-k probabilities lie a rounding apart otherwise, which
#: these relative gaps also hold
FAMILY_GRAD_F32_RTOL = 1e-3
FAMILY_GRAD_BF16_RATIO = 1.5
#: 16e: musicgen-large served at full width and depth, as QWEN_SERVE
MUSICGEN_SERVE = (4, 2048, 32, 2048, None)


def _mm_weights(cfg):
    """Weight elements that multiply every token's activations in a
    matrix product (``aten.mm``) of a train step, times their calls ->
    (those under the remat policy: the attention, MLP, router, Mamba2
    projections and xLSTM input and gate matrices of each layer, and the
    LM head (the embedding, when tied); those outside it: the hybrid's
    shared attention block, once a call).  Not in either: norms and
    biases, the Mamba2 convolutions (elementwise), the MoE experts and the
    sLSTM's recurrent blocks (batched products, ``aten.bmm``), the front
    end's projector (:func:`_mm_flops_formula`)."""
    from repro_torch.models import api
    from repro_torch.models.layers import ParamSpec

    def walk(t, path, per_layer):
        if isinstance(t, ParamSpec):
            shape = t.shape[1:] if per_layer else t.shape
            name = path[-1]
            if len(shape) != 2 or name.startswith("conv_") or \
                    name == "frontend_proj" or (name == "embed" and
                                                not cfg.tie_embeddings):
                return 0
            return math.prod(t.shape)
        return sum(walk(v, path + (k,), per_layer or k == "layers")
                   for k, v in t.items())
    t = api.param_template(cfg)
    inside = walk({k: v for k, v in t.items() if k != "shared_attn"}, (),
                  False)
    outside = api.num_shared_attn(cfg) * walk(t["shared_attn"], (), False) \
        if "shared_attn" in t else 0
    return inside, outside


def _mm_flops_formula(cfg, B, S) -> int:
    """``aten.mm`` FLOPs of a train step at remat "none": 6 T per weight
    element of :func:`_mm_weights` (2 T in the forward, 2 T for the
    input's gradient, 2 T for the weight's), and 4 per element of the
    front end's projector for each of its inputs, the audio model's T
    frames or the vision model's B x VISION_PATCHES patches (the forward
    and the weight's gradient: the inputs need none)."""
    T = B * S
    n = 6 * T * sum(_mm_weights(cfg))
    inputs = {"audio_frames": T, "vision_patches": B * VISION_PATCHES}
    n += 4 * inputs.get(cfg.frontend, 0) * cfg.frontend_dim * cfg.d_model
    return n


def _attn_calls(cfg, remat="none") -> int:
    """Kernel 7's launches in a train step: once an attention call, and
    again in the backward for the calls under remat "full" (every layer's;
    the hybrid's shared block is outside the remat)."""
    from repro_torch.models import api
    if cfg.family == "hybrid":
        return api.num_shared_attn(cfg)
    n = 0 if cfg.attention_free else cfg.num_layers
    return 2 * n if remat == "full" else n


#: a front end's input in a batch, by ``cfg.frontend``
FRONT_END_INPUTS = {"audio_frames": "frames", "vision_patches": "patches"}
#: the patches of a vision model's batch (``launch.dryrun.input_specs``'s)
VISION_PATCHES = 256


def family_data_fn(cfg, B, S):
    """Seeded batches of B x S: uniform tokens, the next as labels, and a
    front end's inputs (normal, f32): an audio model's (B, S) frames, a
    vision model's (B, VISION_PATCHES) patches; the same for a step on
    every call (replay)."""
    def data_fn(step: int):
        rng = np.random.default_rng(1600 + step)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        name = FRONT_END_INPUTS.get(cfg.frontend)
        if name is not None:
            out[name] = rng.standard_normal(
                (B, S if name == "frames" else VISION_PATCHES,
                 cfg.frontend_dim)).astype(np.float32)
        return out
    return data_fn


def _on_card(torch, dev, batch):
    """A batch of :func:`family_data_fn` on the card, a front end's inputs
    in bf16 (the dry run's input specs)."""
    return {k: torch.from_numpy(v).to(dev).to(torch.bfloat16)
            if k in FRONT_END_INPUTS.values() else torch.from_numpy(v).to(dev)
            for k, v in batch.items()}


def _family_run(arch, B, S, layers, remat):
    from repro_torch.configs import SHAPES, get_model_config, get_run_config
    cfg = get_model_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    run = get_run_config(arch, "train_4k", model=cfg, remat=remat)
    return dataclasses.replace(run, shape=dataclasses.replace(
        SHAPES["train_4k"], name="train_4k-cut", seq_len=S, global_batch=B))


def _train_record(arch, run):
    """The dry run's train record of ``run`` (``arch``'s "train_4k" cell
    with the cut model, shape and remat)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, "train_4k",
                          out_dir=str(DRYRUN_DIR), force=True, overrides=dict(
                              model=run.model, shape=run.shape,
                              remat=run.remat))
    if rec["status"] != "ok":
        raise AssertionError(f"the dry run of {arch}'s train step failed: "
                             f"{rec}")
    return rec


def _family_dryrun(arch, run):
    """:func:`_train_record` of ``run`` and its trace at remat "none",
    whose weight products :func:`_mm_flops_formula` gives exactly (under
    remat "full" the recompute stops at the last saved tensor, so a
    block's last product may not run twice)."""
    from repro_torch.launch import dryrun
    rec = _train_record(arch, run)
    none, _ = dryrun.trace_cell(dataclasses.replace(run, remat="none"))
    return rec, none


def family_plan(arch):
    """16's dry run of ``arch`` (meta tensors on the host): FAMILY_TRAIN's
    run, moonshot cut to the first of MOE_TRAIN_LAYERS whose peak
    estimate is within MOE_TRAIN_PEAK_LIMIT, any other arch's batch
    halved until the dry run says it fits one card.  -> (batch, layers,
    the train record, the remat-"none" trace's FLOPs by op, seconds)"""
    B, S, remat, _ = FAMILY_TRAIN[arch]
    layers = None
    t0 = time.perf_counter()
    if arch == "moonshot-v1-16b-a3b":
        for layers in MOE_TRAIN_LAYERS:
            run = _family_run(arch, B, S, layers, remat)
            rec, none = _family_dryrun(arch, run)
            if rec["memory"]["peak_estimate_bytes"] <= MOE_TRAIN_PEAK_LIMIT:
                break
    else:
        run = _family_run(arch, B, S, layers, remat)
        rec, none = _family_dryrun(arch, run)
        while not rec["fits_one_card"] and run.shape.global_batch > 1:
            B = run.shape.global_batch // 2
            run = _family_run(arch, B, S, layers, remat)
            rec, none = _family_dryrun(arch, run)
    return B, layers, rec, dict(none.flops_by_op), time.perf_counter() - t0


def family_plans(phases):
    """The dry runs of phases 16 and 17 among ``phases``, in a process of
    its own beside the card's phases (they use no device: 62 s of phase
    16 when it ran them in turn, on the slower of two H100 hosts): ->
    {16: {arch: :func:`family_plan`} for every FAMILY_TRAIN arch, 17:
    :func:`full_plans`}."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    torch.set_num_threads(1)
    out = {}
    if 16 in phases:
        out[16] = {arch: family_plan(arch) for arch in FAMILY_TRAIN}
    if 17 in phases:
        out[17] = full_plans()
    return out


def start_family_plans(phases):
    """:func:`family_plans` started in a spawned process -> (its pool, to
    terminate, and the pending result)."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, pool.apply_async(family_plans, (sorted(phases),))


def _loss_grads(torch, run, impl, params, batch):
    """``loss_fn`` of ``run``'s model with ``attn_impl=impl`` and its
    gradients over every leaf (no optimizer) -> (loss, grads as a list)."""
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(live)
    loss, _ = api.loss_fn(run.model, tree_map(lambda _: next(it), params),
                          batch, remat=run.remat, attn_impl=impl)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), list(grads)


def _gap(a, b) -> float:
    """Relative L2 distance of two gradient lists, as one vector."""
    num = sum(float((x.float() - y.float()).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.float().square().sum()) for y in b)
    return math.sqrt(num / max(den, 1e-60))


class _FixedRouting:
    """The MoE's top-k choices (``models.moe.route``) of the passes run in
    its ``with``: a ``"record"`` pass keeps each routing call's choices, a
    later ``"count"`` pass routes by its own and counts the tokens whose
    set of experts differs from the recorded call's, a ``"replay"`` pass
    counts them too and routes by the recorded choices (the weights of
    those experts from its own probabilities).  Calls are matched by
    their order, so the passes have to run the same model the same way
    (remat's recompute routes a second time, and is counted)."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.route = torch, moe, moe.route
        self.choices, self.mode, self.calls, self.flips = [], None, 0, 0

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def run(self, mode, fn):
        self.mode, self.calls, self.flips = mode, 0, 0
        try:
            return fn()
        finally:
            self.mode = None
            if mode != "record" and self.calls != len(self.choices):
                raise AssertionError(f"phase 16: {self.calls} routing "
                                     f"calls, {len(self.choices)} recorded")

    def _route(self, router, xf, top_k):
        probs, topw, topi = self.route(router, xf, top_k)
        if self.mode == "record":
            self.choices.append(topi.detach())
        elif self.mode is not None:
            want = self.choices[self.calls]
            self.calls += 1
            self.flips += int((topi.sort(-1)[0] != want.sort(-1)[0])
                              .any(-1).sum())
            if self.mode == "replay":
                topi = want
        if self.mode in ("record", "replay"):
            # the sorted probabilities route() takes its weights from,
            # gathered at the choices: the same bits where they agree
            topw = probs.gather(1, topi)
            topw = topw / self.torch.clamp_min(topw.sum(-1, keepdim=True),
                                               1e-9)
        return probs, topw, topi


def family_grads_both_ways(torch, dev, run, params, batch):
    """16: one step's gradients with kernel 7 and with the plain chunked
    attention at 1 x S, in f32 and in bf16 (FAMILY_GRAD_*).  In the MoE
    the f32 pair is compared with the chunked pass's top-k choices given
    to the flash pass (:class:`_FixedRouting`): where two experts'
    probabilities lie closer than the two passes' f32 difference, a token
    takes another expert in each and the gradients part by that expert's
    share, not by the attention's error; the pair with each pass's own
    choices is printed beside it, with the tokens that took another set of
    experts.  -> numbers; raises when a gap misses its limit."""
    from repro_torch.optim.optimizers import tree_map
    one = {k: v[:1] for k, v in batch.items()}
    p32 = tree_map(lambda t: t.float(), params)
    routing = {}
    if run.model.family == "moe":
        with _FixedRouting(torch) as fixed:
            _, want = fixed.run("record", lambda: _loss_grads(
                torch, run, "chunked", p32, one))
            routing["grads_f32_flash_vs_chunked_own_routing"] = _gap(
                fixed.run("count", lambda: _loss_grads(
                    torch, run, "flash", p32, one))[1], want)
            routing["route_calls"] = fixed.calls
            routing["route_flips_own_routing"] = fixed.flips
            f32_gap = _gap(fixed.run("replay", lambda: _loss_grads(
                torch, run, "flash", p32, one))[1], want)
    else:
        _, want = _loss_grads(torch, run, "chunked", p32, one)
        f32_gap = _gap(_loss_grads(torch, run, "flash", p32, one)[1], want)
    del p32
    gc.collect()
    loss_c, g = _loss_grads(torch, run, "chunked", params, one)
    bf16_chunked = _gap(g, want)
    del g
    loss_f, g = _loss_grads(torch, run, "flash", params, one)
    bf16_flash = _gap(g, want)
    del g, want
    gc.collect()
    torch.cuda.empty_cache()
    nums = dict(
        grads_shape=f"1x{run.shape.seq_len}",
        grads_f32_flash_vs_chunked=f32_gap, **routing,
        grads_bf16_flash_vs_f32_chunked=bf16_flash,
        grads_bf16_chunked_vs_f32_chunked=bf16_chunked,
        loss_bf16_flash=loss_f, loss_bf16_chunked=loss_c,
        grads_f32_rtol=FAMILY_GRAD_F32_RTOL,
        grads_bf16_ratio=FAMILY_GRAD_BF16_RATIO)
    ok = (f32_gap <= FAMILY_GRAD_F32_RTOL
          and bf16_flash <= FAMILY_GRAD_BF16_RATIO * bf16_chunked
          and abs(loss_f - loss_c) <= TRAIN_LOSS_TOL)
    phase("family_grads_both_ways", card=CARD, arch=run.model.arch_id,
          **nums, loss_tol=TRAIN_LOSS_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"phase 16: {run.model.arch_id}: kernel 7's "
                             f"step against the plain attention's: {nums}")
    return nums


def _to_cpu(torch, tree):
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _busy_share(torch, fn):
    """The device's busy share over ``fn()`` (one step) from a
    torch.profiler trace of the device's activity alone (the host's ops
    would cost ~0.5 ms each to process)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / 1e6
    return out, (busy / wall if rows else None), sum(r[2] for r in rows)


def family_train(torch, dev, arch, plan):
    """16a-d: ``arch``'s train step on the card beside its dry run
    (``plan``: :func:`family_plan`'s result): FLOP
    terms by formula, the measured peak of a step against the estimate,
    FAMILY_TRAIN's timed steps (each loss finite and printed), s a step,
    tokens/s, MFU, busy share and kernel 7's launches a step; kernel 7's
    gradients against the plain attention's (the attention families);
    the MoE's step twice from one state, bit-equal.  -> numbers"""
    from repro_torch.configs import get_model_config
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import make_train_step
    _, S, remat, steps = TRAIN_SHAPES[arch]
    B, layers, rec, none_flops, trace_s = plan
    run = _family_run(arch, B, S, layers, remat)
    t0 = t1 = time.perf_counter()
    cfg = run.model
    data_fn = family_data_fn(cfg, B, S)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        run.seed), dev)
    step_fn, opt = make_train_step(run)
    state = opt.init(params)
    batch = _on_card(torch, dev, data_fn(0))
    params, state, m = step_fn(params, state, batch, 0)          # warm-up
    losses = [float(m["loss"])]
    gc.collect()
    args = _tree_bytes(params) + _tree_bytes(state) + _tree_bytes(batch)
    mode = "attention_free" if cfg.attention_free else "flash"
    (out, first_s, peak), launches = counted_run(
        torch, f"family_train_step {arch}", mode,
        lambda: _measured_peak(torch, args, lambda: step_fn(
            params, state, batch, 1)), engine="train_step")
    params, state, m = out
    del out
    secs = [first_s]
    losses.append(float(m["loss"]))
    for i in range(2, steps + 1):
        batch = _on_card(torch, dev, data_fn(i))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t2)
    steps_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    busy = kernels = None
    if not cfg.attention_free:
        batch = _on_card(torch, dev, data_fn(steps + 1))
        out, busy, kernels = _busy_share(
            torch, lambda: step_fn(params, state, batch, steps + 1))
        params, state, m = out
        del out
        losses.append(float(m["loss"]))
    profile_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    nums = {}
    if cfg.family == "moe":
        # the same step twice from one state: bit-equal parameters.  The
        # step's attention is the plain chunked one, whose backward adds
        # nothing by atomics (kernel 8 adds dQ's sums in any order; its
        # deterministic mode is a card test of its own), so every op of
        # the MoE runs as in training
        chunked_fn, _ = make_train_step(run, attn_impl="chunked")
        batch = _on_card(torch, dev, data_fn(steps + 2))
        first = _to_cpu(torch, chunked_fn(params, state, batch,
                                          steps + 2)[0])
        gc.collect()
        again = chunked_fn(params, state, batch, steps + 2)[0]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(again), tree_leaves(first)))
        del first, again
        nums["moe_step_twice_bit_equal"] = same
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if not cfg.attention_free:
        nums.update(family_grads_both_ways(
            torch, dev, run, params, _on_card(torch, dev, data_fn(0))))
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t1
    # the dry run's terms against their formulas and the card's count
    r, mem = rec["roofline"], rec["memory"]
    ff = flash_flops(B, cfg.num_heads, S, S, cfg.head_dim, True)
    k7 = rec["flops_by_op"].get("repro_torch.flash_attention_fwd", 0.0)
    k7_card = launches.get("ss_flash_attention_fwd", 0) * ff
    terms = dict(
        mm_products=(none_flops.get("aten.mm", 0.0),
                     _mm_flops_formula(cfg, B, S)),
        kernel7_forward=(none_flops.get(
            "repro_torch.flash_attention_fwd", 0.0), _attn_calls(cfg) * ff),
        kernel7=(k7, _attn_calls(cfg, run.remat) * ff),
        kernel7_card=(k7, k7_card))
    flops_ok = all(abs(a - b) <= DRYRUN_FLOP_RTOL * max(b, 1.0)
                   for a, b in terms.values())
    peak_ok = _peak_ok(mem["peak_estimate_bytes"], peak)
    step_s = sum(secs) / len(secs)
    tokens = B * S
    nums.update(
        arch=arch, family=cfg.family, layers=cfg.num_layers,
        depth_cut=None if layers is None else
        f"{get_model_config(arch).num_layers} -> {layers}",
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        batch=B, seq=S, remat=run.remat, optimizer=run.optimizer.name,
        losses="/".join(f"{x:.5f}" for x in losses),
        sec_per_step=step_s, step_s="/".join(f"{x:.4f}" for x in secs),
        tokens_per_s=tokens / step_s,
        mfu=r["model_flops_per_chip"] / step_s / dryrun.PEAK_FLOPS,
        model_flops=r["model_flops_per_chip"],
        counted_flops=r["hlo_flops_per_chip"],
        counted_tflops_per_s=r["hlo_flops_per_chip"] / step_s / 1e12,
        busy_share=busy if busy is not None else
        "not measured (the per-token loop's kernels)",
        busy_kernels=kernels,
        measured_peak_gb=peak / 1e9,
        peak_estimate_gb=mem["peak_estimate_bytes"] / 1e9,
        peak_estimate_over_measured=mem["peak_estimate_bytes"] / peak,
        fits_one_card=rec["fits_one_card"],
        kernel7_launches_a_step=launches.get("ss_flash_attention_fwd", 0),
        dryrun_t_compute_s=r["t_compute_s"], dryrun_t_mem_s=r["t_mem_s"],
        step_over_t_compute=step_s / r["t_compute_s"],
        step_over_t_mem=step_s / r["t_mem_s"], dryrun_trace_s=trace_s,
        steps_s=steps_s, profile_s=profile_s, checks_s=checks_s,
        **{f"{k}_dryrun": a for k, (a, _) in terms.items()},
        **{f"{k}_formula": b for k, (_, b) in terms.items()},
        peak_band=DRYRUN_PEAK_BAND, flops_ok=flops_ok, peak_ok=peak_ok,
        seconds=time.perf_counter() - t0)
    phase("family_train", card=CARD, **nums)
    ok = flops_ok and peak_ok and all(math.isfinite(x) for x in losses) \
        and nums.get("moe_step_twice_bit_equal", True)
    if not ok:
        raise AssertionError(f"phase 16: {arch}'s train step: {nums}")
    return nums


def xlstm_trainer(torch, dev):
    """16b: ``Trainer.train()`` of xlstm-125m at FAMILY_TRAIN's shape with
    sealed batches, sealed checkpoints and a ``node_loss``
    (XLSTM_TRAINER), beside an uninterrupted run of the same steps: the
    recovered run's parameters equal it bit for bit (both under
    ``torch.use_deterministic_algorithms``).  -> numbers"""
    import shutil
    from repro_torch.ft.failures import FailureInjector
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    arch = "xlstm-125m"
    B, _, remat, _ = FAMILY_TRAIN[arch]
    S, steps, every, fail_at = XLSTM_TRAINER
    run = _family_run(arch, B, S, None, remat)
    data_fn = family_data_fn(run.model, B, S)
    shutil.rmtree(FAMILY_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        plain = Trainer(run, data_fn, TrainerConfig(
            total_steps=steps, ckpt_every=10 ** 9, log_every=1,
            ckpt_dir=str(FAMILY_CKPT_DIR / "unused")), device=dev)
        plain.run_steps(0, steps)
        want = [t.cpu() for t in tree_leaves(plain.params)]
        want_losses = [h["loss"] for h in plain.history]
        del plain
        gc.collect()
        t1 = time.perf_counter()
        tr = Trainer(run, data_fn, TrainerConfig(
            total_steps=steps, ckpt_every=every, log_every=1,
            ckpt_dir=str(FAMILY_CKPT_DIR)),
            injector=FailureInjector({fail_at: "node_loss"}), device=dev)
        out, launches = counted_run(torch, "xlstm_trainer", "attention_free",
                                    tr.train, engine="train")
        train_s = time.perf_counter() - t1
        got = tree_leaves(tr.params)
        equal = len(got) == len(want) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got, want))
        losses = [h["loss"] for h in out["history"]]
        secs = [h["sec_per_step"] for h in out["history"]]
        del tr, got, want
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(FAMILY_CKPT_DIR, ignore_errors=True)
    nums = dict(arch=arch, batch=B, seq=S, steps=steps, ckpt_every=every,
                fail_at=fail_at, restarts=out["restarts"],
                replayed_steps=out["replayed_steps"],
                final_step=out["final_step"], recovered_bit_equal=equal,
                losses="/".join(f"{x:.5f}" for x in losses),
                uninterrupted_losses="/".join(f"{x:.5f}" for x in
                                              want_losses),
                sec_per_step_median=sorted(secs)[len(secs) // 2],
                train_s=train_s, seconds=time.perf_counter() - t0,
                **{f"launches_{k}": v for k, v in launches.items() if v})
    phase("xlstm_trainer", card=CARD, **nums)
    if not (equal and out["restarts"] == 1 and out["final_step"] == steps
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"phase 16b: the recovered run: {nums}")
    return nums


def phase_family_training(torch, dev, plans):
    """Phase 16: zamba2-1.2b, xlstm-125m (and its Trainer), moonshot-v1-
    16b-a3b cut in depth and musicgen-large trained on the card beside
    their dry runs (``plans``: :func:`family_plans`' pending result); then
    musicgen-large served at full width and depth.  -> (kernel 7
    launches a train step by arch, numbers by arch, kernel 7 launches in
    musicgen's serving run)"""
    t0 = time.perf_counter()
    plans = plans.get()[16]
    phase("family_plans", waited_s=round(time.perf_counter() - t0, 3),
          **{f"{a}_dryrun_s": round(p[4], 3) for a, p in plans.items()})
    numbers, launches, secs = {}, {}, {}
    for arch in FAMILY_TRAIN:
        t1 = time.perf_counter()
        numbers[arch] = family_train(torch, dev, arch, plans[arch])
        launches[arch] = numbers[arch]["kernel7_launches_a_step"]
        if arch == "xlstm-125m":
            numbers["xlstm-125m trainer"] = xlstm_trainer(torch, dev)
        secs[arch] = round(time.perf_counter() - t1, 3)
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    serve_launches, numbers["musicgen-large serve"] = phase_full_serve(
        torch, dev, "musicgen-large", MUSICGEN_SERVE, "musicgen_serve")
    secs["musicgen serve"] = round(time.perf_counter() - t1, 3)
    phase("family_training", card=CARD,
          seconds=round(time.perf_counter() - t0, 3),
          **{f"{k}_s": v for k, v in secs.items()})
    return launches, numbers, serve_launches


# ------------------------------------------------------------------ phase 17

#: phase 17: the configs that had never run on the card, served at full
#: width at 15b's and 16e's shape (requests x prompt tokens, new tokens,
#: the profiled prefill's prompt tokens, as FAMILY_SERVE), each at the
#: largest depth whose dry-run prefill (R x S) and decode (R at S + N)
#: peak estimates are both within SERVE_PEAK_LIMIT bytes: ~8 GB of the
#: card's 80 left for the checks at 1 x S
FULL_SERVE = ("qwen2.5-32b", "granite-34b", "internvl2-76b",
              "kimi-k2-1t-a32b")
FULL_SERVE_SHAPE = (4, 2048, 32, 2048, None)
SERVE_PEAK_LIMIT = 72e9
#: 17e: the vlm's train step on the card (batch x sequence with
#: VISION_PATCHES patches, remat, timed steps) at the largest depth whose
#: dry-run peak estimate is within TRAIN_PEAK_LIMIT bytes, the batch
#: halved while no depth is
VLM_ARCH = "internvl2-76b"
VLM_TRAIN = (4, 2048, "full", 2)
TRAIN_PEAK_LIMIT = 72e9
#: every train step's shape, by arch (phase 16's and 17e's)
TRAIN_SHAPES = {**FAMILY_TRAIN, VLM_ARCH: VLM_TRAIN}
#: kimi-k2's train step (its Adafactor), planned only: one layer at 1 x
#: 2,048 does not fit one card, so no depth of it trains there
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_TRAIN = (1, 2048, "full", 1)


def _largest_depth(fits, full: int) -> int:
    """The largest L <= ``full`` with ``fits(L)``, for a ``fits`` that
    turns false as L grows (a peak estimate within a limit), or 0 when
    not even one layer fits: L doubled from 1 while it fits, then
    bisected (a trace's time grows with L, so the deep ones come last)."""
    if not fits(1):
        return 0
    lo = 1
    while lo < full:
        hi = min(2 * lo, full)
        if not fits(hi):
            break
        lo = hi
    else:
        return full
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def serve_plan(arch):
    """17's dry run of ``arch`` served at FULL_SERVE_SHAPE (meta tensors on
    the host): the largest depth whose prefill and decode peak estimates
    are both within SERVE_PEAK_LIMIT.  -> (layers, the prefill record,
    the decode record, seconds); raises when not even one layer fits."""
    from repro_torch.configs import get_model_config
    R, S, N, _, _ = FULL_SERVE_SHAPE
    cfg = get_model_config(arch)
    records = {}
    t0 = time.perf_counter()

    def fits(L):
        cut = dataclasses.replace(cfg, num_layers=L)
        pre = _dryrun_shape(arch, "prefill_32k", S, R, "prefill", cut)
        dec = None
        if pre["memory"]["peak_estimate_bytes"] <= SERVE_PEAK_LIMIT:
            dec = _dryrun_shape(arch, "decode_32k", S + N, R, "decode", cut)
        records[L] = (pre, dec)
        return dec is not None and \
            dec["memory"]["peak_estimate_bytes"] <= SERVE_PEAK_LIMIT
    L = _largest_depth(fits, cfg.num_layers)
    if not L:
        raise AssertionError(f"phase 17: {arch} does not fit one card at "
                             f"one layer: {records[1][0]['memory']}")
    return (L, *records[L], time.perf_counter() - t0)


def vlm_train_plan():
    """17e's dry run of VLM_ARCH's train step: VLM_TRAIN's batch, halved
    while no depth fits, at the largest depth whose peak estimate is
    within TRAIN_PEAK_LIMIT.  -> (batch, layers, the train record, the
    remat-"none" trace's FLOPs by op, seconds), as :func:`family_plan`"""
    from repro_torch.configs import get_model_config
    from repro_torch.launch import dryrun
    B, S, remat, _ = VLM_TRAIN
    full = get_model_config(VLM_ARCH).num_layers
    t0 = time.perf_counter()
    while True:
        records = {}

        def fits(L):
            records[L] = _train_record(VLM_ARCH, _family_run(
                VLM_ARCH, B, S, L, remat))
            return records[L]["memory"]["peak_estimate_bytes"] <= \
                TRAIN_PEAK_LIMIT
        L = _largest_depth(fits, full)
        if L or B == 1:
            break
        B //= 2
    if not L:
        raise AssertionError(f"phase 17e: {VLM_ARCH} does not train on one "
                             f"card at one layer: {records[1]['memory']}")
    none, _ = dryrun.trace_cell(dataclasses.replace(
        _family_run(VLM_ARCH, B, S, L, remat), remat="none"))
    return B, L, records[L], dict(none.flops_by_op), \
        time.perf_counter() - t0


def kimi_train_plan():
    """The dry run of kimi-k2's train step at KIMI_TRAIN (one layer, its
    own optimizer), which does not run: -> numbers."""
    B, S, remat, _ = KIMI_TRAIN
    t0 = time.perf_counter()
    run = _family_run(KIMI_ARCH, B, S, 1, remat)
    rec = _train_record(KIMI_ARCH, run)
    mem = rec["memory"]
    return dict(arch=KIMI_ARCH, layers=1, batch=B, seq=S, remat=remat,
                optimizer=run.optimizer.name,
                peak_estimate_gb=mem["peak_estimate_bytes"] / 1e9,
                argument_gb=mem["argument_bytes"] / 1e9,
                trains_on_one_card=rec["fits_one_card"],
                dryrun_s=time.perf_counter() - t0)


def full_plans():
    """Phase 17's dry runs: {"serve": {arch: :func:`serve_plan`}, "vlm":
    :func:`vlm_train_plan`, "kimi": :func:`kimi_train_plan`}."""
    return dict(serve={arch: serve_plan(arch) for arch in FULL_SERVE},
                vlm=vlm_train_plan(), kimi=kimi_train_plan())


def phase_full_configs(torch, dev, plans):
    """Phase 17: qwen2.5-32b, granite-34b, internvl2-76b (with sealed
    patches) and kimi-k2 served at full width (:func:`phase_full_serve`)
    at the depths their dry runs fit (``plans``: :func:`family_plans`'
    pending result), then internvl2-76b trained at its planned depth and
    batch (:func:`family_train`); kimi-k2's train plan printed.  ->
    ({arch: kernel 7 launches in its serving run}, numbers by arch)"""
    from repro_torch.configs import get_model_config
    t0 = time.perf_counter()
    plans = plans.get()[17]
    serve, kimi = plans["serve"], plans["kimi"]
    phase("full_plans", waited_s=round(time.perf_counter() - t0, 3),
          serve_peak_limit_gb=SERVE_PEAK_LIMIT / 1e9,
          train_peak_limit_gb=TRAIN_PEAK_LIMIT / 1e9,
          **{f"{a}_layers": f"{p[0]}/{get_model_config(a).num_layers}"
             for a, p in serve.items()},
          **{f"{a}_prefill_estimate_gb":
             p[1]["memory"]["peak_estimate_bytes"] / 1e9
             for a, p in serve.items()},
          **{f"{a}_decode_estimate_gb":
             p[2]["memory"]["peak_estimate_bytes"] / 1e9
             for a, p in serve.items()},
          **{f"{a}_plan_s": round(p[3], 3) for a, p in serve.items()},
          vlm_batch=plans["vlm"][0], vlm_layers=plans["vlm"][1],
          vlm_estimate_gb=plans["vlm"][2]["memory"]["peak_estimate_bytes"]
          / 1e9, vlm_plan_s=round(plans["vlm"][4], 3))
    phase("kimi_train_plan", **kimi)
    launches, numbers, secs = {}, {}, {}
    for arch in FULL_SERVE:
        t1 = time.perf_counter()
        L, pre, dec, _ = serve[arch]
        launches[arch], numbers[arch] = phase_full_serve(
            torch, dev, arch, FULL_SERVE_SHAPE, "full_serve", layers=L,
            records=(pre, dec))
        secs[arch] = round(time.perf_counter() - t1, 3)
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers[f"{VLM_ARCH} train"] = family_train(torch, dev, VLM_ARCH,
                                                plans["vlm"])
    secs["vlm_train"] = round(time.perf_counter() - t1, 3)
    numbers[f"{KIMI_ARCH} train plan"] = kimi
    phase("full_configs", card=CARD,
          seconds=round(time.perf_counter() - t0, 3),
          **{f"{k}_s": v for k, v in secs.items()})
    return launches, numbers


def run_phases(torch, dev, args, phases, mixes, probes, plans, mark):
    """Phases 2-17 of ``phases``, each after ``mark(its number)`` ->
    what the kernels' line reads of them (see :func:`main`)."""
    mark(2)
    kernels = []
    if 2 in phases:
        kernels = phase_kernels(torch, dev, probes)
        mark("2 oracle")
        kernels += phase_kernels_oracle(torch, dev,
                                        np.random.default_rng(1), probes)
        mark("2 aead")
        phase_aead_kernels(torch, dev, np.random.default_rng(2))
        phase_enclave_kernels(torch, dev, np.random.default_rng(3), probes)
        phase_reducer(torch, dev, np.random.default_rng(4))
    mark(3)
    # launches on each engine's main path: the window engine's DelayedFlights
    # run (phase 3) for kernels 1-3, the oracle engine's timed enclave run
    # (phase 7) for kernels 4-6
    launches = {}
    flights_out = busy_ms = None
    if 3 in phases:
        launches["window"], flights_out = phase_delayed_flights(
            torch, dev, args.records)
        busy_ms = phase_profile(torch, dev, 256 * CHUNK_RECORDS)
        mark("3 attribution")
        phase_attribution(torch, dev, ATTRIBUTION_RECORDS)
    mark(4)
    window_results = phase_modes(torch, dev, MODES_RECORDS) \
        if 4 in phases else None
    mark(5)
    if 5 in phases:
        phase_rekey(torch, dev, 64 * CHUNK_RECORDS)
    mark(6)
    if 6 in phases:
        phase_stage8(torch, dev, 2048)
    mark(7)
    if 7 in phases:
        launches["chunk"] = phase_oracle(torch, dev, window_results)
    mark(8)
    extra = phase_chunk_copy(torch, dev, mixes, probes) \
        if 8 in phases else {}
    mark(9)
    if 9 in phases:
        kernels.append(phase_flash(torch, dev))
    mark(10)
    if 10 in phases:
        launches["serve"] = phase_serve(torch, dev)
    mark(11)
    if 11 in phases:
        phase_ft_flights(torch, dev, args.records, flights_out)
        mark("11b")
        phase_ft_stage8(torch, dev)
        mark("11c")
        phase_observation_cost(torch, dev, OBS_RECORDS)
        mark("11d")
        phase_trace(torch, dev, busy_ms)
    mark(12)
    wire_launches, wire_rows = phase_secure_wire(torch, dev) \
        if 12 in phases else ({}, {})
    mark(13)
    train_launches, train_numbers = phase_training(torch, dev) \
        if 13 in phases else ({}, {})
    # phase 13's memory, before 14's: its Trainer sits in a reference
    # cycle (its timed save/restore wrap its own bound methods), which
    # only the cycle collector frees, with its state and snapshot
    gc.collect()
    torch.cuda.empty_cache()
    mark(14)
    head_dims, family_launches, family_numbers = phase_families(torch, dev) \
        if 14 in phases else ({}, {}, {})
    gc.collect()
    torch.cuda.empty_cache()
    mark(15)
    qwen_launches, dryrun_numbers = phase_dryrun(torch, dev, train_numbers) \
        if 15 in phases else (None, {})
    gc.collect()
    torch.cuda.empty_cache()
    mark(16)
    fam_train_launches, fam_train, musicgen_launches = \
        phase_family_training(torch, dev, plans) if 16 in phases \
        else ({}, {}, None)
    gc.collect()
    torch.cuda.empty_cache()
    mark(17)
    full_launches, full_numbers = phase_full_configs(torch, dev, plans) \
        if 17 in phases else ({}, {})
    return (kernels, launches, extra, wire_launches, wire_rows,
            train_launches, train_numbers, head_dims, family_launches,
            family_numbers, qwen_launches, dryrun_numbers,
            fam_train_launches, fam_train, musicgen_launches,
            full_launches, full_numbers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=RECORDS,
                    help="DelayedFlights records of phase 3")
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
                    help="comma-separated phases to run")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    # phase 13 runs with deterministic algorithms: cuBLAS needs a fixed
    # workspace for that, set before it is first initialised
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    marks = []

    def mark(name):
        """Phase ``name`` starts: its time since the start, kept for the
        last line's per-phase seconds and written to the standard error,
        so that a run stopped at its time limit shows where it was."""
        marks.append((name, time.perf_counter() - t_start))
        print(f"chip_smoke: phase {name} starts at {marks[-1][1]:.1f} s",
              file=sys.stderr, flush=True)
    phase("start", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0],
          device=torch.cuda.get_device_name(0))
    mark(1)
    mixes, probes = phase_card_and_build(torch)
    # phases 16's and 17's dry runs need no device: they run beside
    # phases 2-15
    pool, plans = start_family_plans(phases) if phases & {16, 17} \
        else (None, None)
    try:
        (kernels, launches, extra, wire_launches, wire_rows, train_launches,
         train_numbers, head_dims, family_launches, family_numbers,
         qwen_launches, dryrun_numbers, fam_train_launches, fam_train,
         musicgen_launches, full_launches, full_numbers) = run_phases(
             torch, dev, args, phases, mixes, probes, plans, mark)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    for k in kernels:
        sym = k.pop("symbol")
        run = LAUNCHES_FROM[k["name"]]
        k["launches"] = launches[run][sym] if run in launches else None
        k.update(extra.get(k["name"], {}))
        if k["name"] in wire_rows:
            k.setdefault("shapes", {})["checkpoint"] = wire_rows[k["name"]]
            k["launches_secure_wire"] = {
                run: n[sym] for run, n in wire_launches.items() if n[sym]}
        if k["name"] in train_launches:
            k["launches_secure_training"] = train_launches[k["name"]]
        if k["name"] == "flash_attention_fwd" and train_numbers:
            k["training"] = train_numbers
        if k["name"] == "flash_attention_fwd" and head_dims:
            k["head_dims"] = head_dims
            k["launches_families"] = family_launches
            k["families"] = {a: {f: n[f] for f in (
                "ttft_ms", "prefill_tokens_per_s", "decode_ms_per_step",
                "peak_memory_gb", "prefill_busy_share")}
                for a, n in family_numbers.items()}
        if k["name"] == "flash_attention_fwd" and dryrun_numbers:
            q = dryrun_numbers["qwen"]
            k["launches_qwen"] = qwen_launches
            k["qwen"] = {f: q[f] for f in (
                "ttft_ms", "prefill_tokens_per_s", "decode_ms_per_step",
                "peak_memory_gb", "prefill_busy_share")}
        if k["name"] == "flash_attention_fwd" and fam_train:
            k["launches_family_training_a_step"] = fam_train_launches
            k["launches_musicgen_serve"] = musicgen_launches
            k["family_training"] = {a: {f: n[f] for f in (
                "batch", "seq", "layers", "sec_per_step", "tokens_per_s",
                "mfu", "busy_share", "measured_peak_gb",
                "peak_estimate_over_measured")}
                for a, n in fam_train.items() if "mfu" in n}
        if k["name"] == "flash_attention_fwd" and full_numbers:
            k["launches_full_serve"] = full_launches
            k["full_configs"] = {a: {f: n.get(f) for f in (
                "layers", "ttft_ms", "prefill_tokens_per_s",
                "decode_ms_per_step", "peak_memory_gb", "sec_per_step",
                "mfu", "kernel7_launches_a_step")}
                for a, n in full_numbers.items() if "plan" not in a}
    mark("end")
    phase("done", seconds=round(time.perf_counter() - t_start, 3),
          phase_seconds=json.dumps({
              str(n): round(t1 - t0, 1) for (n, t0), (_, t1)
              in zip(marks, marks[1:])}, separators=(",", ":")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
