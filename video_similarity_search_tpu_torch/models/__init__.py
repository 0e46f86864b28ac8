from .heads import Dropout, LinearClassifier, R3DEmbedder, S3DEmbedder
from .moco import MoCoBank, MoCoEncoder
from .r3d import R3DNet
from .registry import compute_dtype, embedding_dim, model_selector
from .resnet3d import (BasicBlock3d, Bottleneck3d, ResNet3D,
                       backbone_feature_dim, generate_model)
from .s3d import S3D, select_backbone
from .slowfast import SinglePathwayResNet, SlowFast, multipathway_input
from .triplet_net import TripletNet, pairwise_dist

__all__ = [
    "compute_dtype",
    "embedding_dim",
    "model_selector",
    "BasicBlock3d",
    "Bottleneck3d",
    "ResNet3D",
    "backbone_feature_dim",
    "generate_model",
    "Dropout",
    "LinearClassifier",
    "MoCoBank",
    "MoCoEncoder",
    "R3DEmbedder",
    "R3DNet",
    "S3D",
    "S3DEmbedder",
    "SinglePathwayResNet",
    "SlowFast",
    "TripletNet",
    "multipathway_input",
    "pairwise_dist",
    "select_backbone",
]
