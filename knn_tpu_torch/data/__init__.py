"""knn_tpu_torch.data — see the modules for their knn_tpu counterparts."""
