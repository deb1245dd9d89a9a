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
   share and the kernels that take its time; then the job over 8 M
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
   in its ``-Xptxas -v`` lines; timed beside its bound (and the share of
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
   fault-free for every launch the audit log shows a fault wasted;
   ``ft.*`` counters, seconds and records/s.  (b) the 8-stage job
   (phase 6's, 256 chunks) under ``ChaosPlan.seeded`` for 4 seeds,
   encrypted and enclave: bit-equal to the fault-free sum and numpy.
   (c) what observation and ft cost: DelayedFlights at 8 M records bare,
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

Every pipeline run of phases 3-7 and 11, the serving run of phase 10
and the sealed and plain runs of phase 12 set the kernels' launch counts
to 0 just before each and read them just
after: it fails unless exactly the kernels of its mode's path on its
engine were launched (window engine: the cipher pass and kernels 2-3 in
enclave mode, the pass and 2 in encrypted mode; per-chunk engine: the
pass and kernels 5-6, and the pass and 5; plain mode none; serving: the
pass, 5 and 7, kernel 7 once per layer in the prefill and never in
decode; phase 12's sealed runs: the cipher pass and kernel 2, its
plain runs none).  Kernel 3 is ``ss_enclave_map_window`` there; the rows
entry runs on no path.  The fault-tolerant engine (phase 11) is the window
engine's path: retries, failovers, backups and replays re-execute a
share through the same kernels, the window hop with ``nonces_out``.

Then one JSON line with every kernel's numbers (``launches`` from the
main run of its path: phase 3 for kernels 1-3, phase 7's timed run for
kernels 4-6, phase 10's serving run for kernel 7; rows 1 and 4 both
count the cipher pass, each on its own path; rows 1 and 2 also carry
phase 12's launches and their numbers at the checkpoint's shape), and as
the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is available.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 at
# 3.35 TB/s; 32-bit integer ops on the CUDA cores at the issue limit,
# 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz boost = 33.5 T ops/s (the
# data sheet lists no int32 rate; the kernels do integer work only).  An
# SM has 64 INT32 lanes, and nvcc sends adds, moves and shifts to its
# FP32 lanes as IMAD, so integer work can use all 128 lanes an SM issues
# to per clock: counting the INT32 lanes alone would understate the peak.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# dense tensor-core bf16 and CUDA-core f32 peaks (data sheet): kernel 7
BF16_TC_FLOPS = 989e12
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
    # AEAD (kernels 4 and 5), the prefill runs kernel 7 in every layer
    "serve": {
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_mac_tags",
                      "ss_flash_attention_fwd"),
    },
    # the secure wire (phase 12): every seal and open is a batched AEAD
    # call (the cipher pass and kernel 2); the exchanges are copies
    "wire": {
        "plain": (),
        "encrypted": ("ss_chacha20_cipher_pass", "ss_cwmac_tags"),
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
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
    from torch.profiler's device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


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
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
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


#: phase 3's attribution: DelayedFlights records of each run
ATTRIBUTION_RECORDS = 8 * 1024 * 1024


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
    launched, so summing every row would count that time twice."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


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
    min(i+1, Skv) keys; each costs one exp2 in the softmax."""
    if causal:
        full = min(Sq, Skv)
        pairs = full * (full + 1) // 2 + max(Sq - Skv, 0) * Skv
    else:
        pairs = Sq * Skv
    return B * H * pairs


def flash_flops(B, H, Sq, Skv, D, causal):
    """FLOPs kernel 7 needs: 2*D for q.k and 2*D for p*v per attended
    (query, key) pair."""
    return 4 * D * flash_pairs(B, H, Sq, Skv, causal)


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
           2)
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
    src = (build.CSRC / "flash_attention.cu").read_text()
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


def phase_flash(torch, dev):
    """Kernel 7 against its plain version on the card at FLASH_SHAPES,
    bf16 and f32, causal and not; then its time at the serving path's
    shape beside its bound, the plain version and SDPA.  -> its row."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_RTOL, attention_ref, bf16_mismatch)
    ptxas = {}
    for k in build.ptxas_kernels(build.ptxas_report()):
        if "flash" in k["name"]:
            ptxas["bf16" if "bf16" in k["name"] else "f32"] = k
            if k["spill_stores"] != 0 or k["spill_loads"] != 0:
                raise AssertionError(f"{k['name']} spills registers")
    g = torch.Generator(device=dev).manual_seed(9)
    D = flash_ops.HEAD_DIM

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
    b, by = bound(4 * q.numel() * q.element_size(), flops, BF16_TC_FLOPS)
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
               smem_bytes=flash_ops.smem_bytes(),
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
                        steps=16):
    """Device busy share of one prefill at the serving shape and of
    ``steps`` decode steps after it (the engine's steps), each under its
    own torch.profiler window, and the kernels that take the device's
    time in each."""
    from torch.profiler import ProfilerActivity, profile
    state = {}

    def prefill():
        logits, state["cache"] = prefill_step(params, {"tokens": prompts})
        state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]

    def decode_steps():
        for pos in range(SERVE_PROMPT, SERVE_PROMPT + steps):
            state["tok"], _, state["cache"] = decode(
                params, state["tok"], pos, state["cache"])
    for part, fn in (("prefill", prefill), ("decode", decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(device_rows(prof), key=lambda r: -r[1])
        if not rows:
            phase("serve_profile", part=part, device_busy="not measured "
                  "(no device time in the trace)", wall_s=round(wall, 4))
            continue
        busy = sum(r[1] for r in rows) / 1e6
        phase("serve_profile", part=part, steps=steps if part == "decode"
              else 1, wall_s=round(wall, 4), device_busy_s=round(busy, 4),
              device_busy_share=round(busy / wall, 4),
              kernels=sum(r[2] for r in rows))
        for key, t_us, count in rows[:10]:
            print(f"   device {t_us / 1e3:10.3f} ms  {count:7d} calls  "
                  f"{key[:90]}", flush=True)


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
#: which form C scrapes its metrics endpoint
OBS_RECORDS = 8 * 1024 * 1024
OBS_SCRAPE_CHUNK = 4096
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
    return sum(1 for e in dump
               if (e["kind"] == "worker_failed" and e["reason"] == "crash")
               or (e["kind"] == "share_failover"
                   and e["reason"] == "backup")
               or e["kind"] == "window_replayed")


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
    wasted (``check_footprint``)."""
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
    if hops - free_hops != reexec:
        raise AssertionError(
            f"ft DelayedFlights: {hops} window-hop launches against "
            f"{free_hops} fault-free, the audit shows {reexec} "
            f"re-executions that cost a launch")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=RECORDS,
                    help="DelayedFlights records of phase 3")
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12",
                    help="comma-separated phases to run")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

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
    phase("start", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0],
          device=torch.cuda.get_device_name(0))
    mixes, probes = phase_card_and_build(torch)
    kernels = []
    if 2 in phases:
        kernels = phase_kernels(torch, dev, probes)
        kernels += phase_kernels_oracle(torch, dev,
                                        np.random.default_rng(1), probes)
        phase_aead_kernels(torch, dev, np.random.default_rng(2))
        phase_enclave_kernels(torch, dev, np.random.default_rng(3), probes)
        phase_reducer(torch, dev, np.random.default_rng(4))
    # launches on each engine's main path: the window engine's DelayedFlights
    # run (phase 3) for kernels 1-3, the oracle engine's timed enclave run
    # (phase 7) for kernels 4-6
    launches = {}
    flights_out = busy_ms = None
    if 3 in phases:
        launches["window"], flights_out = phase_delayed_flights(
            torch, dev, args.records)
        busy_ms = phase_profile(torch, dev, 256 * CHUNK_RECORDS)
        phase_attribution(torch, dev, ATTRIBUTION_RECORDS)
    window_results = phase_modes(torch, dev, MODES_RECORDS) \
        if 4 in phases else None
    if 5 in phases:
        phase_rekey(torch, dev, 64 * CHUNK_RECORDS)
    if 6 in phases:
        phase_stage8(torch, dev, 2048)
    if 7 in phases:
        launches["chunk"] = phase_oracle(torch, dev, window_results)
    extra = phase_chunk_copy(torch, dev, mixes, probes) \
        if 8 in phases else {}
    if 9 in phases:
        kernels.append(phase_flash(torch, dev))
    if 10 in phases:
        launches["serve"] = phase_serve(torch, dev)
    if 11 in phases:
        phase_ft_flights(torch, dev, args.records, flights_out)
        phase_ft_stage8(torch, dev)
        phase_observation_cost(torch, dev, OBS_RECORDS)
        phase_trace(torch, dev, busy_ms)
    wire_launches, wire_rows = phase_secure_wire(torch, dev) \
        if 12 in phases else ({}, {})
    for k in kernels:
        sym = k.pop("symbol")
        run = LAUNCHES_FROM[k["name"]]
        k["launches"] = launches[run][sym] if run in launches else None
        k.update(extra.get(k["name"], {}))
        if k["name"] in wire_rows:
            k.setdefault("shapes", {})["checkpoint"] = wire_rows[k["name"]]
            k["launches_secure_wire"] = {
                run: n[sym] for run, n in wire_launches.items() if n[sym]}
    phase("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
