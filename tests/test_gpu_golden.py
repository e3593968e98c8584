"""Golden parity on the GPU: detect with the battery on the device must
byte-match the checked-in golden files, as on the CPU (every device
result is an exact integer, finalized in float64 on the host).

Skips without a GPU.  On the card:
    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

from test_golden import GOLDEN, VARIANTS, _golden, _run, pools  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_golden_sign_test_on_gpu(gpu, pools, tmp_path, name):  # noqa: F811
    from nanomod.stats.battery import battery_backend

    assert battery_backend() == "device"
    assert _run(pools, tmp_path, name) == _golden(name)
    if name == "capped":
        with open(os.path.join(str(tmp_path), "capped_meanstd.cvs"),
                  "rb") as f:
            got = f.read()
        with open(os.path.join(GOLDEN, "golden_capped_meanstd.cvs"),
                  "rb") as f:
            assert got == f.read()
