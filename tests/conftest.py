"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, the default set here
when the variable is unset) with 8 virtual host devices, so the
multi-device sharding paths run without a card. Tests that need a GPU
carry the ``gpu`` marker and the ``gpu`` fixture, which skips them
unless JAX's backend is a GPU; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_device.py``
(the card-only tests live there; other test modules import packages the
card machine may lack).
"""

import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _xla_flags:
    os.environ["XLA_FLAGS"] = (
        _xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest

REFERENCE_FIXTURES = Path("/root/reference/tests/fixtures")


@pytest.fixture
def gpu() -> None:
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    from pyani_plus_tpu.device import gpu_available

    if not gpu_available():
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="session")
def fixtures_dir() -> Path:
    """Reference repo golden fixture directory (read-only)."""
    if not REFERENCE_FIXTURES.is_dir():
        pytest.skip("reference fixtures not available")
    return REFERENCE_FIXTURES


@pytest.fixture(scope="session")
def viral_example(fixtures_dir: Path) -> Path:
    """Three ~39-58kb phage genomes: the main golden set."""
    return fixtures_dir / "viral_example"


@pytest.fixture(scope="session")
def bacterial_example(fixtures_dir: Path) -> Path:
    """Four gzipped bacterial genomes (fast methods only)."""
    return fixtures_dir / "bacterial_example"


@pytest.fixture(scope="session")
def bad_alignments(fixtures_dir: Path) -> Path:
    """Two divergent phages with no alignable regions (all-NULL)."""
    return fixtures_dir / "bad_alignments"
