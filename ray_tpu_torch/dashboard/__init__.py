from ray_tpu_torch.dashboard.dashboard import Dashboard, run_dashboard  # noqa: F401
