"""A module-scope fixture that runs a test module's torch work on one
intra-op thread (import ``one_thread`` into the module; it is autouse).

Under ``pytest -n 6`` every worker's torch would start as many threads as
the host has cores, and a plain version made of thousands of small ops
(the partitioned sketch encode's pass 2 at a width past 2^24, a launcher
overfitting a smoke model) then waits at every op on threads the other
workers keep busy. On an 8-core CPU one case that takes 4.5 s alone ran
709 s under ``-n 6``, and six copies of it side by side did not end in
900 s; on one thread each the six took 4.3-4.8 s. The cases compute the same
values on any thread count: integer and dyadic sums, or results held to
a tolerance."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
