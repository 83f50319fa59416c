"""One torch thread for each module of the benchmark's tests
(``portbench/tests``), as the program's test files pin their own: beside
other test workers, a thread a core oversubscribes the CPU far enough
that the fault tests' 0.3 s windows close before their second answer."""
from pathlib import Path

import pytest

BENCH_TESTS = Path(__file__).resolve().parent / "portbench" / "tests"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_in_bench_tests(request):
    if BENCH_TESTS not in Path(request.node.path).resolve().parents:
        yield
        return
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
