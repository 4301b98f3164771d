"""`python -m ray_tpu_torch` == the port's `rt` CLI."""

from ray_tpu_torch.scripts.scripts import main

if __name__ == "__main__":
    main()
