"""repro_torch.dist — the distribution layer of the port.

The paper scales its secure-stream pipelines across workers connected by
encrypted channels (§4-5, Fig. 7/8).  Port of ``repro/dist``, one module
each:

* :mod:`repro_torch.dist.meshctx`           — named worker axes and the
  logical-axis sharding rules (``MeshContext``);
* :mod:`repro_torch.dist.collectives`       — the ZeroMQ shuffler as an
  (optionally AEAD-sealed) all-to-all of mailbox blocks;
* :mod:`repro_torch.dist.pipeline_parallel` — the GPipe microbatch
  schedule whose stage boundaries are sealed with the ChaCha20/CW-MAC
  channel.

The port is single-process, as the reference is single-program SPMD: an
axis of size W is W workers whose shards all live on one device, and a
collective is its result computed on that device.
"""
from repro_torch.dist.meshctx import MeshContext, local_mesh_context  # noqa: F401
