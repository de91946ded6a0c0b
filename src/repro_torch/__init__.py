"""PyTorch + CUDA port of the ``repro`` package (MLA serving on one
NVIDIA H100).

The JAX package ``repro`` is the reference; this package imports neither
it nor ``jax``.  Modules mirror ``repro``'s layout and names:

    configs/    model configs (DeepSeek-V2, DeepSeek-V3)
    nn/         layers and parameter init
    core/       paged latent pool, MLA math, scheme dispatch
    kernels/    the paged MLA attention CUDA kernels and their plain
                PyTorch versions
    models/     MoE, sublayers, the LM stack
    hwmodel/    the paper's roofline cost model
    obs/        serving telemetry: tracer, metrics, roofline drift, logger
    runtime/    scheduler, radix prefix cache, the paged serving engine,
                jax.random's threefry PRNG (prng.py)
    launch/     the serving CLI
    weights.py  moves a ``repro`` parameter tree into the port

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
