"""The build cache (counterpart of ``mslesions3d_tpu/utils/cache.py``).

The JAX package keeps a persistent XLA compile cache, keyed by the runtime's
build, because its programs take minutes to compile and a cache served
across a runtime upgrade loaded stale executables. The port compiles
nothing but its native sources: the CUDA kernels and the NIfTI loader,
which ``kernels/build.py`` (``build_library``) builds at first use into
``build/`` at the root of the checkout. That is this module's counterpart,
and it carries the JAX module's one lesson over: a library's name hashes
its source, its flags and its compiler's ``--version``, so an upgraded
toolkit builds anew instead of loading a stale library. Nothing else
compiles (no ``torch.compile``), so there is nothing to cache here.
"""
