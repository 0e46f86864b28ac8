"""PyTorch/CUDA port of ``video_similarity_search_tpu`` for one NVIDIA H100.

Subpackages mirror the JAX package's names (``config``, ``models``,
``ops``, ``cluster``, ``evaluation``, ``train``, ``data``, ``utils``) so
each module's counterpart is easy to find. This package imports torch and
never jax, flax or the JAX package. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when CUDA is absent; pass
``device="cpu"`` to run the plain PyTorch versions of every kernel.

Ported so far: the serving path — R3D-18 embedding, FINCH clustering over
the hand-written CUDA 1-NN kernel (``csrc/nn1_cosine.cu``), and cosine
top-k retrieval.
"""

__version__ = "0.1"
