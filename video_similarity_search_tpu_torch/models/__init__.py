from .registry import compute_dtype, embedding_dim, model_selector
from .resnet3d import BasicBlock3d, Bottleneck3d, ResNet3D, generate_model

__all__ = [
    "compute_dtype",
    "embedding_dim",
    "model_selector",
    "BasicBlock3d",
    "Bottleneck3d",
    "ResNet3D",
    "generate_model",
]
