"""The paper's own benchmark application: the DelayedFlights pipeline.

Computes, per air carrier, the average delay and the count of delayed
flights over a flight-record stream (paper §5.2, Table 1), as a
map -> filter -> reduce SecureStreams pipeline under one of the three
security modes of Fig. 6.  Copied from the reference's
``repro/configs/securestreams_flightdelay.py``.
"""
from dataclasses import dataclass

from repro_torch.configs.base import SecureStreamConfig

ARCH_ID = "securestreams-flightdelay"


@dataclass(frozen=True)
class FlightPipelineConfig:
    num_carriers: int = 20          # paper: 20 air carriers
    num_records: int = 1_000_000    # scaled-down from the paper's 28M
    record_words: int = 8           # uint32 words per record
    workers_per_stage: int = 1      # paper scales 1 / 2 / 4
    chunk_records: int = 2_048      # records per stream chunk
    secure: SecureStreamConfig = SecureStreamConfig(mode="enclave")


CONFIG = FlightPipelineConfig()
