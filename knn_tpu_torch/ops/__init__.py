"""knn_tpu_torch.ops — see the modules for their knn_tpu counterparts."""
