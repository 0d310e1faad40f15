"""The JAX package's command-line scripts (scripts/), ported: run each as
`python -m instascene_tpu_torch.scripts.<name>`."""
