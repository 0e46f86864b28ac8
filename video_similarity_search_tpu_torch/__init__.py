"""PyTorch/CUDA port of ``video_similarity_search_tpu`` for one NVIDIA H100.

Subpackages mirror the JAX package's names (``config``, ``models``,
``ops``, ``cluster``, ``evaluation``, ``train``, ``data``, ``parallel``,
``utils``) so each module's counterpart is easy to find. This package imports torch and
never jax, flax or the JAX package. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when CUDA is absent; pass
``device="cpu"`` to run the plain PyTorch versions of every kernel.

Ported so far: the serving path — R3D-18 embedding, FINCH clustering over
the hand-written CUDA 1-NN kernel (``csrc/nn1_cosine.cu``), and cosine
top-k retrieval — and the host data path around it: the config parser,
manifests, the JPEG loaders (the native C++ decoder ``native/vss_loader.cpp``
or PIL), the prefetching loader with its pinned side-stream upload, the
iterative-cluster step (``train/driver.py``) and the evaluate CLI
(``python -m video_similarity_search_tpu_torch.cli.evaluate``).
"""

__version__ = "0.1"
