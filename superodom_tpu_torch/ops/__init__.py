from superodom_tpu_torch.ops.eigh3 import solve3  # noqa: F401
