"""Quantization: QAT (fake-quant) and PTQ (calibration), with int8
execution in ``quant.py`` (port of ``paddle_tpu/quantization/``; the
JAX package's export list)."""

from .quant import (FakeQuantLayer, ImperativeQuantAware, PTQ,  # noqa: F401
                    QuantConfig, QuantizedConv2D, QuantizedLinear,
                    fake_quant, quant_dequant)
