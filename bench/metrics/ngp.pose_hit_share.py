"""Share of the window's slots the pose cache served from a plan (hit or
warp tier), from the engine's own counters (`stats()["pose_cache"]`)."""


def read(out):
    c = out.counters
    if "pose_hits" not in c:
        return None
    n = c["pose_hits"] + c["pose_warps"] + c["pose_misses"]
    return None if not n else 100.0 * (c["pose_hits"] + c["pose_warps"]) / n
