"""The port's ProgressReporter (utils/progress.py) writes the reference's
characters (acceleratedvolrenderer_tpu/utils/progress.py): the same
updates under the same patched clock, into two StringIO streams."""
import io
from unittest import mock

import pytest

from acceleratedvolrenderer_tpu.utils import progress as jprogress
from acceleratedvolrenderer_tpu_torch.utils import progress as tprogress

# (units done, clock) of each update: throttled redraws, a completed bar
# inside the throttle window, an overshoot and a zero-time start
SCRIPTS = {
    "throttled": [(1, 0.1), (1, 0.2), (3, 0.6), (1, 0.7), (2, 1.3),
                  (2, 1.4)],
    "overshoot": [(4, 0.0), (4, 0.3), (9, 0.31)],
    "one_step": [(1, 0.0)],
}


def _run(module, total, title, quiet, steps, finish_at):
    clock = {"t": 0.0}
    out = io.StringIO()
    with mock.patch.object(module.time, "time", lambda: clock["t"]):
        rep = module.ProgressReporter(total, title=title, quiet=quiet,
                                      stream=out)
        for n, t in steps:
            clock["t"] = t
            rep.update(n)
        clock["t"] = finish_at
        elapsed = rep.elapsed
        rep.finish()
    return out.getvalue(), rep.done, elapsed


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_progress_text_identical(name, quiet):
    for total, title in ((10, "Rendering"), (0, "Graph build")):
        want = _run(jprogress, total, title, quiet, SCRIPTS[name], 2.5)
        got = _run(tprogress, total, title, quiet, SCRIPTS[name], 2.5)
        assert got == want
        if not quiet:
            assert got[0].endswith(" " * 30 + "\n")
