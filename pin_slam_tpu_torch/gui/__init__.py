"""Process/queue visualization architecture (reference: gui/). The
port's own copy of `pin_slam_tpu/gui/`; it imports neither torch nor jax."""

from pin_slam_tpu_torch.gui.gui_utils import (ControlPacket, ParamsGUI,
                                              VisPacket, apply_control,
                                              get_latest_queue)
from pin_slam_tpu_torch.gui.slam_viewer import start_viewer, stop_viewer

__all__ = ["VisPacket", "ControlPacket", "ParamsGUI", "get_latest_queue",
           "apply_control", "start_viewer", "stop_viewer"]
