"""Replayed learning runs against ``repro``'s: the MLP under the uniform
policy and logreg with the trimmed defense
(``tests/test_torch_learn.py``'s ``ENGINE_CASES``; two a file, so that
the slow replays spread over the test workers)."""

import pytest

from test_torch_learn import (check_replayed_learning_run,  # noqa: F401
                              one_thread, working_barrier)


@pytest.mark.parametrize("case", ["mlp-uniform", "logreg-trimmed"])
def test_replayed_learning_run_equals_repro(working_barrier, case):
    check_replayed_learning_run(case)
