"""The port's artifact tooling: ``refresh_bench_artifacts`` (curate the
port's bench lines into ``GPU_BENCH_r{N}.jsonl``) and ``perf_sentinel``
(lint the bench history, judge the newest curated round); each runs as
``python -m knn_tpu_torch.scripts.<name>``."""
