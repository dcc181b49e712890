"""The train scripts (counterparts of `scripts/train_materials_tensor.py`
and `scripts/train_atomic_tensor.py`), run as modules:

    python -m matten_tpu_torch.scripts.train_materials_tensor [config.yaml]
    python -m matten_tpu_torch.scripts.train_atomic_tensor [config.yaml]
"""
