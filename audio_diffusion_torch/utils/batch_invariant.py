"""The process-wide window in which a row's result does not depend on its batch.

On a CUDA device cuDNN picks other convolution kernels for other batch
shapes, and they round a row differently (chip_smoke.py's ``[tier]`` names
the calls); PyTorch's own convolutions compute each row alone. The serving
contract (a request's spectrogram bitwise the same alone or batched, at eta
0) therefore needs cuDNN off while a batch runs.

``torch.backends.cudnn.enabled`` is one flag for the whole process, so the
window is one :class:`.flag_window.FlagWindow`: the first window to open
saves the flag and turns cuDNN off; the last to close puts the saved value
back. Windows may overlap in any order (two batchers, a batcher beside a
sharded call) and the flag stays off while any is open. Every other thread
of the process sees cuDNN off meanwhile: a plain call of the pipeline made
then runs without cuDNN (its fused program is the one captured with cuDNN
off: the flag is part of its signature).
"""

from __future__ import annotations

import torch

from .flag_window import attribute_window

# ``with window():`` runs the body with cuDNN off; nests and overlaps across threads
window = attribute_window(torch.backends.cudnn, "enabled", False)
