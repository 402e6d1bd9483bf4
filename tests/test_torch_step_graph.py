"""ops.step_graph.run_steps on the CPU: the plain versions' step loop, with
the early stop the plain banded walk uses."""

import pytest
import torch

from sequencealigning_tpu_torch.ops import step_graph


@pytest.mark.parametrize("every,stop,want", [(512, 700, 1024), (32, 70, 96),
                                             (512, 5000, 2048)])
def test_run_steps_stops_at_the_first_check_that_holds(every, stop, want):
    counter = torch.zeros((), dtype=torch.int64)
    seen = torch.zeros((), dtype=torch.int64)
    steps = []

    def body():
        steps.append(int(counter))
        seen.add_(1)

    step_graph.run_steps(body, counter, 2048, done=lambda: seen >= stop,
                         every=every)
    assert int(counter) == want == len(steps)
    assert steps == list(range(want))


def test_run_steps_without_done_runs_every_step():
    counter = torch.zeros((), dtype=torch.int64)
    seen = torch.zeros((), dtype=torch.int64)
    step_graph.run_steps(lambda: seen.add_(1), counter, 100, every=32)
    assert int(counter) == int(seen) == 100
