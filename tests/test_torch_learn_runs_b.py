"""Replayed learning runs against ``repro``'s: logreg under the obs_count
policy and logreg with a norm clip
(``tests/test_torch_learn.py``'s ``ENGINE_CASES``; two a file, so that
the slow replays spread over the test workers)."""

import pytest

from test_torch_learn import (check_replayed_learning_run,  # noqa: F401
                              one_thread, working_barrier)


@pytest.mark.parametrize("case", ["logreg-obs_count", "logreg-norm_clip"])
def test_replayed_learning_run_equals_repro(working_barrier, case):
    check_replayed_learning_run(case)
