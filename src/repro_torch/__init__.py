"""repro_torch: SecureStreams on PyTorch and CUDA (engines, DSL, kernels).

A port of :mod:`repro` (the JAX/Pallas reference, which stays the oracle)
module for module: ``repro/<pkg>/<mod>.py`` -> ``repro_torch/<pkg>/<mod>.py``.
It imports ``torch``, ``numpy`` and the standard library only — never
``jax`` and nothing of ``repro``.

Conventions every module follows:

* **Word carrier.** u32 words live in ``torch.int32`` tensors holding the
  u32 bit pattern (:mod:`repro_torch.u32`).  Kernels read them as
  ``uint32_t*``; the plain torch versions lift to ``int64`` and mask.
* **Devices.** Entry points take an explicit ``device`` (default
  ``"cuda"``).  A kernel wrapper runs its plain torch version only for a
  tensor on the CPU; for a CUDA tensor it launches the hand-written
  kernel (``repro_torch/csrc/*.cu``) or raises.
"""
