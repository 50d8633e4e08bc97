"""The cached prefill and decode of the moe family's two smoke configs
(granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b) against ``repro.models`` on
the CPU: ``tests/test_torch_families.py``'s :func:`cached_case`, with
its tolerances and reasons.  A file of its own, so that a run that hands
out whole files to its workers runs it beside the others.
"""

import pytest

pytest.importorskip("jax")
from test_torch_families import cached_case  # noqa: E402


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_prefill_and_decode_match_reference(arch, dtype, kernels):
    cached_case(arch, dtype, kernels)
