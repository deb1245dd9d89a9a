"""seal_open_ms.prefill: host milliseconds a batch of the window spends in
``serve.secure.seal_prompts`` and ``open_prompts`` (ChaCha20 and CW-MAC,
kernels 4 and 5), the open ending in its MAC check's sync; the mean over
the window's batches."""


def read(r):
    spans = r.spans.get("seal_open")
    return 1e3 * sum(spans) / len(spans) if spans else None
