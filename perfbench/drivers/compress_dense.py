"""Driver: the `compress` driver (drivers/compress.py, loaded from its file),
with the profile-0 model pass that the configuration's `model_impl` names.

The port picks its profile-0 pass from ARTC_MODEL_IMPL at each call, so
each call here runs with that variable set to `model_impl` and the
environment's own value put back after it: the cell runs its pass whatever
the environment holds.
"""
from __future__ import annotations

import contextlib
import os

from harness import spec

_compress = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "compress.py"), "perfbench_driver_compress")


@contextlib.contextmanager
def _model_impl(impl: str):
    before = os.environ.get("ARTC_MODEL_IMPL")
    os.environ["ARTC_MODEL_IMPL"] = impl
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("ARTC_MODEL_IMPL", None)
        else:
            os.environ["ARTC_MODEL_IMPL"] = before


class Driver(_compress.Driver):
    def _call(self, data: bytes, info: dict | None = None) -> bytes:
        with _model_impl(self.config["model_impl"]):
            return super()._call(data, info)
