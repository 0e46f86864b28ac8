"""Command-line entry points of the port (``python -m
video_similarity_search_tpu_torch.cli.<name>``)."""
