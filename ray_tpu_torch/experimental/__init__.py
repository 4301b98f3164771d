from ray_tpu_torch.experimental.channel import Channel, ChannelClosed  # noqa: F401
