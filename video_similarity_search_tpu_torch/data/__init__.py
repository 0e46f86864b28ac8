from .augment import normalization_constants, normalize_only
from .datasets import ClipReader, TripletsDataset, VideoDataset
from .loaders import (BinaryImageLoaderPIL, ImageLoaderPIL, VideoLoader,
                      VideoLoaderFlowHDF5, VideoLoaderHDF5)
from .manifests import (get_manifest, load_kinetics_manifest,
                        load_video_manifest, read_cluster_labels,
                        write_cluster_labels)
from .pipeline import (PrefetchLoader, build_data_loader,
                       build_temporal_transforms, collate_triplets,
                       collate_videos, get_channel_extension)

__all__ = [
    "BinaryImageLoaderPIL", "ClipReader", "ImageLoaderPIL",
    "PrefetchLoader", "TripletsDataset", "VideoDataset", "VideoLoader",
    "VideoLoaderFlowHDF5", "VideoLoaderHDF5", "build_data_loader",
    "build_temporal_transforms", "collate_triplets", "collate_videos",
    "get_channel_extension", "get_manifest", "load_kinetics_manifest",
    "load_video_manifest", "normalization_constants", "normalize_only",
    "read_cluster_labels", "write_cluster_labels",
]
