"""knn_tpu_torch.utils — see the modules for their knn_tpu counterparts."""
