"""PyTorch + CUDA port of the ``repro`` package (MLA serving and
training, and the paper's MHA / GQA baseline families, on one NVIDIA
H100).

The JAX package ``repro`` is the reference; this package imports neither
it nor ``jax``.  Modules mirror ``repro``'s layout and names:

    configs/    model configs (DeepSeek-V2 / V3; phi3, starcoder2, granite,
                gemma3, granite-moe, internvl2) and the input shapes
    nn/         layers and parameter init
    core/       KV cache and GQA attention, paged latent pool, MLA math,
                scheme dispatch
    kernels/    the MLA and flash-attention CUDA kernels and their plain
                PyTorch versions
    models/     MoE, sublayers, the LM stack
    hwmodel/    the paper's roofline cost model
    obs/        serving telemetry: tracer, metrics, roofline drift, logger
    runtime/    scheduler, radix prefix cache, the paged serving engine,
                jax.random's threefry PRNG (prng.py)
    launch/     the serving and training CLIs, the HTTP/SSE frontend
    weights.py  moves a ``repro`` parameter tree into the port

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
