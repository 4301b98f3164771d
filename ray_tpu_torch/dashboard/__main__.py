from ray_tpu_torch.dashboard.dashboard import main

if __name__ == "__main__":
    main()
