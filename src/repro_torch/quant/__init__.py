"""Quantization grids, policies, the STE, and the sub-byte storage codec."""
from repro_torch.quant.linear_quant import (
    QuantParams,
    weight_qparams,
    activation_qparams,
    quantize_weight,
    dequantize_weight,
    quantize_activation,
    dequantize_activation,
    fake_quant_weight,
    fake_quant_activation,
)
from repro_torch.quant.packing import (
    PackedTensor,
    pack_codes,
    pack_words,
    unpack_words,
    tensor_store_nbytes,
    policy_model_bytes,
)
from repro_torch.quant.calibration import calibrate_minmax, calibrate_percentile, Calibrator
from repro_torch.quant.policy import QuantUnit, QuantPolicy, UnitKind, fqr
from repro_torch.quant.qat import ste_round, fake_quant_params_tree

__all__ = [
    "QuantParams",
    "weight_qparams",
    "activation_qparams",
    "quantize_weight",
    "dequantize_weight",
    "quantize_activation",
    "dequantize_activation",
    "fake_quant_weight",
    "fake_quant_activation",
    "PackedTensor",
    "pack_codes",
    "pack_words",
    "unpack_words",
    "tensor_store_nbytes",
    "policy_model_bytes",
    "calibrate_minmax",
    "calibrate_percentile",
    "Calibrator",
    "QuantUnit",
    "QuantPolicy",
    "UnitKind",
    "fqr",
    "ste_round",
    "fake_quant_params_tree",
]
