"""Training the vlm (llama-3.2-vision-11b) and encdec (whisper-small) families against the reference on the CPU:
``tests/test_torch_training_families.py``'s :func:`gradient_case`, with
its tolerances and reasons, at 16 tokens.  A file of its own, so that a
run that hands out whole files to its workers runs it beside the others.
"""

import pytest

pytest.importorskip("jax")
from test_torch_training_families import gradient_case  # noqa: E402


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_loss_and_gradients_match_reference(arch, remat, kernels):
    gradient_case(arch, 16, remat, kernels)
