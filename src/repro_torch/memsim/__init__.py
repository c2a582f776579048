"""Silicon-cost model of the (de)compression engines (Table IV): the
port's copy of the reference's ``memsim.hardware``, which the memctl lane
engine calibrates from.  The DDR5 trace replay stays in the reference
until its slice is ported."""

from repro_torch.memsim.hardware import CompressionEngineModel  # noqa: F401
