"""Build and load of the CUDA kernels (``cuda_lib``) and of the C++ host
codec (``native_lib``)."""

from gzp_tpu_torch.runtime.native_lib import NativeCodec, get_native  # noqa: F401
