"""A small size of each configuration, for the CPU tests of the harness:
the same layers and settings at a few hundred points a scan."""

RAW, FILTERED = 8192, 1024

WORLD = {"extent": 10.0, "n_ground": 20000, "n_pillars": 4, "n_walls": 2,
         "noise": 0.02, "max_range": 35.0, "min_range": 0.5}


def overrides(robots: int) -> dict:
    port = {"prefilter": {"capacity_raw_points": RAW,
                          "capacity_filtered_points": FILTERED},
            "slam": {"capacity_keyframe_points": FILTERED}}
    cfg = {"raw_points": RAW, "filtered_points": FILTERED, "world": WORLD,
           "port": port, "block_frames": 8}
    if robots == 1:
        # 48 frames of 0.7 m on a 4 m circle: past 1.3 laps, so loops close
        mix = {"episode_frames": 48, "pool_episodes": 2, "radius_m": 4.0,
               "step_m": 0.7, "trace_episodes": 1}
    else:
        # two blocks of 4 a robot: the second tick has candidates
        cfg["block_frames"] = 4
        mix = {"episode_frames": 16, "pool_episodes": 2, "radius_m": 4.0,
               "step_m": 1.4,
               "robot_windows": [[0, 8], [3, 11], [5, 13], [8, 16]],
               "trace_episodes": 1}
    return {"config": cfg, "traffic": mix}


# the limits at this size, above what a sound run reads here (seed
# 2**31 + 12345, revisit / survey: lanes 0 / 0; odometry 0.040 / 0.095 m;
# loops 0.21 / none, GICP on a world this sparse has no sharp optimum;
# graph 5.2e-4 / 2.2e-6 m)
LIMITS = {"prefilter_lanes_off": 0.01, "odometry_gap_m": 0.3,
          "tick_gap_m": 1.0}
