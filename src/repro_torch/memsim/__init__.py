"""DRAMSim3-lite: event-accurate DDR5 timing/energy + the paper's Table IV
silicon-cost model for the hardware (de)compression engines (the port's
copy of the reference's ``memsim``; plain Python and NumPy).

Reproduces the paper's §IV.B evaluation setup: 4 DRAM channels per module,
each channel hosting 10 ×4 DDR5-4800 devices, driven by access traces from
the functional memory-controller model (:mod:`repro_torch.core.controller`).
"""

from repro_torch.memsim.dram import DDR5Config, DramChannel, DramSystem  # noqa: F401
from repro_torch.memsim.energy import EnergyModel  # noqa: F401
from repro_torch.memsim.hardware import CompressionEngineModel  # noqa: F401
from repro_torch.memsim.trace import replay_controller_trace  # noqa: F401
