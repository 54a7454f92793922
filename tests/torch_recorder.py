"""What the port reported about a block of a test: its recorder
(``pfb_imaging_tpu_torch.utils.profiling``) and its log records.

    with recording() as got:
        run()
    assert got["counters"].get("launch.idg_extract", 0) == 0

``recording`` turns the recorder on, empty; at the block's end the dict it
handed out is filled with what the recorder took (``spans`` and
``counters``), and the recorder is left on or off as it was. ``logged``
collects the per-cycle dicts a command's log lines carry, in process or in
a rank child alike.
"""

import contextlib
import logging

from pfb_imaging_tpu_torch.utils import profiling


@contextlib.contextmanager
def recording():
    was_on = profiling.enabled()
    profiling.take()
    profiling.enable()
    got: dict = {}
    try:
        yield got
    finally:
        got.update(profiling.take())
        if not was_on:
            profiling.disable()


def seconds(spans, name: str) -> float:
    """The seconds of the spans called ``name``, summed."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9


@contextlib.contextmanager
def logged(logger: str, key: str = "cycle"):
    """The ``key`` dicts of the records ``pfb_tpu.<logger>`` logs inside the
    block (``extra={key: ...}``), in order."""
    out: list = []

    class Collect(logging.Handler):
        def emit(self, record):
            if hasattr(record, key):
                out.append(getattr(record, key))

    handler = Collect()
    log = logging.getLogger(f"pfb_tpu.{logger}")
    log.addHandler(handler)
    try:
        yield out
    finally:
        log.removeHandler(handler)


def _under(counters: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in counters.items() if k.startswith(prefix)}


def routes(counters: dict, command: str) -> dict:
    """The routes ``command`` counted (``<command>.route.<route>``): {route:
    count}."""
    return _under(counters, f"{command}.route.")


def launches(counters: dict) -> dict:
    """The kernel launches counted (``launch.<kernel>``): {kernel: count}."""
    return _under(counters, "launch.")
