# Registers the tfrt_torch operators that the kernel wrappers call.
from tensorflowraytrace_tpu_torch.ops import custom_ops  # noqa: F401
