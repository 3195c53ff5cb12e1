"""The flat floor at z = 0: no terrain; 4 corners of each foot geom."""


def terrain(captured, device, dtype):
    if captured is not None:
        raise ValueError("a flat-floor configuration, but the launch was handed a terrain")
    return None


def slot_kinds(model) -> list[str]:
    return ["flat"] * (4 * len(model.foot_geoms))


def extra_bytes(model, batch: int) -> int:
    return 0
