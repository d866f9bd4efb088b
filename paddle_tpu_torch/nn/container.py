"""``Sequential`` (port of ``paddle_tpu/nn/container.py:13-29``).

torch's ``nn.Sequential`` already names its children ``"0"``, ``"1"``,
... as the JAX one does, so state-dict keys such as
``layer1.0.downsample.1._mean`` match without renaming.
"""

from torch.nn import Sequential  # noqa: F401
