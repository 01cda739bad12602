"""Connected-component label propagation: the fixpoint kernel."""
from .ops import (connected_components, label_step, label_step_plain,
                  merge_labels, propagate, propagate_collective,
                  propagate_plain)

__all__ = ["connected_components", "label_step", "label_step_plain",
           "merge_labels", "propagate", "propagate_collective",
           "propagate_plain"]
