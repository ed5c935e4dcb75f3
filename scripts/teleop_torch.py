"""Interactive teleop driver for the simulator with the PyTorch/CUDA port
(graphslam_tpu_torch): the counterpart of scripts/teleop.py, with the same
key map and printed lines, and --device.

Drive the simulated robot through the default world with the
teleop_twist_keyboard key map (u i o / j k l / m , .), feeding scans +
odometry into the online SLAM pipeline and dumping the map image at every
keyframe. `drive` takes the keys from any iterable, so a scripted key string
drives it without a terminal.

Run: python scripts/teleop_torch.py [--out /tmp/slam_map.png] [--device cuda]
Keys: i forward, , back, j/l turn, k stop, q/z speed up/down, Ctrl-C quit.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
from typing import NamedTuple

import numpy as np
import torch

# The reference's moveBindings/speedBindings subset that applies to a
# differential-drive planar robot.
MOVE = {
    "i": (1.0, 0.0), ",": (-1.0, 0.0),
    "j": (0.0, 1.0), "l": (0.0, -1.0),
    "u": (1.0, 1.0), "o": (1.0, -1.0),
    "m": (-1.0, -1.0), ".": (-1.0, 1.0),
    "k": (0.0, 0.0),
}
SPEED = {"q": 1.1, "z": 0.9}
START_POSE = (-7.0, -5.0, 0.0)


class Session(NamedTuple):
    """What stays fixed while driving: the config, the world, the beam
    angles and the SLAM step."""

    cfg: object
    world: object
    angles: torch.Tensor
    step: object


class Drive(NamedTuple):
    """Where driving left off; `stopped` after Ctrl-C."""

    state: object
    pose: torch.Tensor
    speed: float
    turn: float
    tick: int
    stopped: bool


def session(cfg=None, device="cuda"):
    """(Session, empty SLAMState, start pose) for `cfg` (default
    SLAMConfig()) on `device`."""
    from graphslam_tpu_torch.config import SLAMConfig
    from graphslam_tpu_torch.frontend.projection import beam_angles
    from graphslam_tpu_torch.sim import default_world
    from graphslam_tpu_torch.slam import init_state, make_slam_step

    cfg = cfg or SLAMConfig()
    fcfg = cfg.frontend
    s = Session(cfg, default_world(device), beam_angles(fcfg.num_beams, fcfg.fov_rad,
                                                        device=device), make_slam_step(cfg))
    return s, init_state(cfg, device=device), torch.tensor(START_POSE, device=device)


def drive(keys, state, pose, sess: Session, out: str, dt: float = 0.1, speed: float = 0.5,
          turn: float = 1.0, tick: int = 0) -> Drive:
    """Feed each key of `keys` to the robot: a move key moves it for one tick
    of `dt` seconds and runs the SLAM step on the scan there (printing the
    tick's line, and writing the map to `out` at a keyframe), q/z scale the
    speeds, Ctrl-C stops; other keys are ignored. The speed defaults are
    teleop_twist_keyboard.py:82-83's."""
    from graphslam_tpu_torch import viz
    from graphslam_tpu_torch.geometry import se2
    from graphslam_tpu_torch.sim import raycast

    for key in keys:
        if key == "\x03":
            return Drive(state, pose, speed, turn, tick, True)
        if key in SPEED:
            speed *= SPEED[key]
            turn *= SPEED[key]
            print(f"speed {speed:.2f} turn {turn:.2f}")
            continue
        if key not in MOVE:
            continue
        v, w = MOVE[key]
        twist = np.array([v * speed, 0.0, w * turn], np.float32)
        delta = torch.from_numpy(twist * dt).to(pose.device)
        pose = se2.compose(pose, delta)
        ranges = raycast(sess.world, pose, sess.angles, sess.cfg.frontend.max_range)
        state, info = sess.step(state, ranges, delta)
        tick += 1
        print(
            f"t={tick} kf={int(info.num_kf)} factors={int(info.num_factors)} "
            f"fitness={float(info.fitness):.3f}"
            + (" [keyframe]" if bool(info.is_keyframe) else "")
            + (" [loop]" if bool(info.added_loop) else "")
        )
        if bool(info.is_keyframe):
            viz.plot_map(
                state.kf_poses, state.kf_points, state.kf_masks,
                int(state.num_kf), path=out,
            )
    return Drive(state, pose, speed, turn, tick, False)


def getch():
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/slam_map.png")
    ap.add_argument("--dt", type=float, default=0.1)  # willow.world:46 tick
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()

    sess, state, pose = session(device=args.device)
    d = Drive(state, pose, 0.5, 1.0, 0, False)
    print(__doc__)
    while not d.stopped:
        try:
            key = getch()
        except KeyboardInterrupt:
            break
        d = drive(key, d.state, d.pose, sess, args.out, args.dt, d.speed, d.turn, d.tick)
    print(f"map written to {args.out}")


if __name__ == "__main__":
    main()
