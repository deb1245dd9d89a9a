"""Secure serving on the PyTorch port, beside ``secure_serve.py``: a
client attests the server, establishes a session key through the
quote-checked handshake (``repro_torch.attest``), and sends AEAD-sealed
prompts, which are opened at ingest, prefilled (kernel 7 in every layer
on the card) and decoded greedily with a KV cache.

Run:  PYTHONPATH=src python examples/torch_secure_serve.py \\
          --requests 4 --new 16 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.serve import secure
from repro_torch.serve.engine import greedy_generate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    # head_dim 64: the one head dim kernel 7 is built for
    cfg = ModelConfig(arch_id="serve-demo", family="dense", num_layers=2,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=2048, head_dim=64, tie_embeddings=True)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "serve", args.prompt_len, args.requests, "decode"))
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device)

    # attestation + key establishment: the serving enclave is measured
    # and allowlisted; the client verifies its quote during the handshake
    # and the session key seals requests
    directory, key, server_m = secure.attested_session(cfg.arch_id)
    print(f"attested session established (measurement "
          f"{server_m.hex()[:16]}..., epoch {directory.epoch})")
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.requests, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    opened = secure.open_prompts(key, secure.seal_prompts(key, prompts))
    print(f"ingested {args.requests} sealed prompts "
          f"({opened.shape[1]} tokens each), MAC ok")

    t0 = time.perf_counter()
    out = greedy_generate(run, params, opened, steps=args.new,
                          max_seq=args.prompt_len + args.new).cpu()
    dt = time.perf_counter() - t0
    print(f"generated {args.new} tokens x {args.requests} requests "
          f"in {dt:.2f}s ({args.requests * args.new / dt:.1f} tok/s)")
    for r in range(min(args.requests, 2)):
        print(f"  req{r}: ...{opened[r, -4:].tolist()} -> "
              f"{out[r, :8].tolist()}...")


if __name__ == "__main__":
    main()
