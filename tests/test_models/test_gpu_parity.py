"""Card-only check (``gpu`` marker; skipped where JAX sees no GPU): the
card-vs-CPU and TF32-tripwire phases of ``chip_smoke.py``, run as a test.
On a GPU host: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``."""

import jax
import pytest


@pytest.mark.gpu
def test_small_cases_on_the_card_match_the_cpu(gpu_device):
    import chip_smoke

    failures = []
    with jax.default_device(gpu_device):
        card = chip_smoke.phase_card_vs_cpu(jax.devices("cpu")[0],
                                            failures=failures)
        chip_smoke.phase_tf32(card, failures=failures)
    assert failures == []
