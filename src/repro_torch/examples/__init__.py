"""The port's counterparts of the repository's ``examples/*.py``, each
run as ``python -m repro_torch.examples.<name>`` and each with a
``main(argv=None)``: ``quickstart`` (train a few steps, then serve under
the four MLA schemes: identical tokens), ``train_mla`` (the training
trainer with checkpoints and resume) and ``serve_mla`` (a Poisson request
stream on the paged engines).  Every one takes ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions)."""
