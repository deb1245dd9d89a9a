"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) with a plain torch
version beside each: ``<name>/ops.py`` is the wrapper, ``<name>/ref.py``
the plain version, :mod:`.build` builds, loads and counts launches."""
