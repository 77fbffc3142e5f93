"""The compiled train step against the eager one and the reference's on
the SSM and hybrid architectures (reduced mamba2-2.7b and zamba2-1.2b):
``tests/test_torch_train_graphs.py``'s parity case, in a file of its own
so that the two halves run side by side under the test runner's
workers."""
import pytest
import torch

from test_torch_step_graphs import stub  # noqa: F401
from test_torch_train_graphs import (VARIANTS,  # noqa: F401
                                     check_against_eager_and_reference,
                                     deterministic)

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_compiled_step_matches_eager_and_reference(stub, arch, variant):
    check_against_eager_and_reference(stub, arch, variant)
