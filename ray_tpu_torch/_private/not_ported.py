"""The error raised where the runtime core reaches a part of ray_tpu that
the PyTorch port does not have yet.

Plain tasks, actors, put and get never reach one; each call site names
the feature and the ROADMAP item that brings it (A2b lists the rest of
the runtime in the order it lands).
"""


def not_ported(feature: str, item: str = "A2b") -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not in the PyTorch port yet (ROADMAP {item})")
