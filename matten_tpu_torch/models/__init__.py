from matten_tpu_torch.models.tfn import (
    OUT_FIELD,
    AtomicTensorModel,
    ScalarTensorModel,
    create_atomic_tensor_model,
    create_scalar_tensor_model,
    create_tfn_backbone,
)

__all__ = [
    "OUT_FIELD",
    "AtomicTensorModel",
    "ScalarTensorModel",
    "create_atomic_tensor_model",
    "create_scalar_tensor_model",
    "create_tfn_backbone",
]
