"""knn_tpu_torch.parallel — see the modules for their knn_tpu counterparts."""
