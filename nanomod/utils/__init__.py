from nanomod.utils.observe import (
    Observer, observer, stage, report, device_trace, vlog,
)

__all__ = ["Observer", "observer", "stage", "report", "device_trace", "vlog"]
