"""Synthetic datasets (copy of the flight records of
``repro/data/synthetic.py``, so both packages see the same data).

``flight_records``: the paper's DelayedFlights workload (§5.2) — records of
(carrier, delay_minutes, ...) packed as 16 uint32 words each (one ChaCha20
block per record, so enclave ops are record-aligned).  The real dataset is
28M rows; the generator is deterministic per seed and scales.  Records are
numpy ``uint32``; view them as ``int32`` (:func:`repro_torch.u32.from_numpy`)
before they enter the port.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

RECORD_WORDS = 16  # one cipher block per record
CARRIER_WORD = 0
DELAY_WORD = 1
DISTANCE_WORD = 2


def flight_records(n_records: int, num_carriers: int = 20,
                   seed: int = 0) -> np.ndarray:
    """(n_records, 16) uint32 packed records."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((n_records, RECORD_WORDS), dtype=np.uint32)
    rec[:, CARRIER_WORD] = rng.integers(0, num_carriers, n_records)
    # delay minutes: mixture of on-time (<=15) and delayed (heavy tail)
    delayed = rng.random(n_records) < 0.35
    delay = np.where(delayed,
                     rng.gamma(2.0, 30.0, n_records),
                     rng.uniform(0, 15, n_records)).astype(np.uint32)
    rec[:, DELAY_WORD] = delay
    rec[:, DISTANCE_WORD] = rng.integers(100, 5000, n_records)
    rec[:, 3] = rng.integers(0, 2 ** 31, n_records)  # opaque payload
    return rec


def flight_chunks(n_records: int, chunk_records: int, num_carriers: int = 20,
                  seed: int = 0) -> Iterator[np.ndarray]:
    """Consecutive whole chunks of :func:`flight_records` (the tail that
    does not fill a chunk is dropped)."""
    data = flight_records(n_records, num_carriers, seed)
    for i in range(0, n_records - chunk_records + 1, chunk_records):
        yield data[i:i + chunk_records]
