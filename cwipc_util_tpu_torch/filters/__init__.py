"""Point-cloud filters: uniform ``filter(pc) -> pc`` stages.

The port of the filters of cwipc_util_tpu/filters/ that the registration
fixtures need: ``simulatecams`` and ``noise``, on the shared
:class:`~.abstract.BaseFilter`.  The other filters and the string factory
(used by the CLI) are not ported yet.
"""
