"""Camera-batch data parallelism on torch.distributed (port of
instascene_tpu/parallel/)."""
