"""passthrough filter (reference: python/cwipc/filters/passthrough.py).

The port of cwipc_util_tpu/filters/passthrough.py.
"""

from .abstract import BaseFilter


class PassthroughFilter(BaseFilter):
    """
    passthrough - Do-nothing filter, for testing the filter plumbing.
        Arguments: none
    """

    filtername = "passthrough"

    def _process(self, pc):
        return pc


CustomFilter = PassthroughFilter
