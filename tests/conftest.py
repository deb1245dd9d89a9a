"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see 1 CPU
device; only launch/dryrun.py forces the 512-device host platform."""
import jax
import pytest

from repro.dist.meshctx import local_mesh_context


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture(scope="session")
def ctx():
    return local_mesh_context()


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)


@pytest.fixture(autouse=True, scope="module")
def _fresh_obs_state():
    """Reset process-global observability state at each module boundary
    so counter/histogram/audit assertions are order-independent.

    * ``obs.metrics.REGISTRY.reset()`` zeroes every registered
      instrument — including the AEAD compile-cache stats the previous
      version of this fixture reset (any module may warm the cache with
      arbitrary shapes) and the host-sync/dispatch counters the window
      engine asserts on.  Instruments stay REGISTERED: hot-path
      references (module-level ``_FP_HITS`` etc.) remain valid, and
      compiled programs are kept — dropping them would re-pay ~2 s/shape
      compiles per module; tests that need a cold cache call
      ``aead.reset_fastpath_cache()`` themselves.
    * ``dist.pipeline_parallel._DEFAULT_DIRS`` caches KeyDirectories
      across tests; their owned AuditLogs would otherwise accumulate
      events across modules and flip exact-count assertions with test
      ordering.
    """
    from repro.dist import pipeline_parallel as _pp
    from repro.obs.metrics import REGISTRY
    REGISTRY.reset()
    for d in _pp._DEFAULT_DIRS.values():
        d.audit.clear()
    yield
