from .tracker import (CenterTracker, greedy_assignment,
                      NUSC_TRACKING_NAMES, NUSC_CLS_VELOCITY_ERROR,
                      WAYMO_TRACKING_NAMES)

__all__ = ["CenterTracker", "greedy_assignment", "NUSC_TRACKING_NAMES",
           "NUSC_CLS_VELOCITY_ERROR", "WAYMO_TRACKING_NAMES"]
