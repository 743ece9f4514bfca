#!/usr/bin/env python3
"""The conditioning of the inertial whitening on chip_smoke.py's phase I
corridor, in both packages, on the CPU: for every frame gap (1/15 s) and
every keyframe gap of 0.25 s and 0.5 s (the inertial keyframe spacing
before and after the IMU initialisation) over 20 s of the corridor's IMU
(200 Hz, cfg.imu's noise, phase I's biases), the condition number of the
9x9 preintegration covariance with its 1e-8 floor, and how far the f32
whitening cholesky(inv(cov + 1e-8 I)) of each package is from the f64 one
(largest entry difference over the largest entry).

    JAX_PLATFORMS=cpu python3 tools/imu_conditioning.py

Needs JAX for the reference's side (run where the reference runs).
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax.numpy as jnp
    from orbslam3lib_tpu.tracking import imu as jimu
    from orbslam3lib_tpu_torch.config import ImuConfig
    from orbslam3lib_tpu_torch.io.synthetic import corridor_imu_stream
    from orbslam3lib_tpu_torch.tracking import imu as timu
    from orbslam3lib_tpu_torch.tracking.inertial_opt import sqrt_info
    ci = ImuConfig()
    sg, sa = ci.noise_gyro * np.sqrt(ci.freq), ci.noise_acc * np.sqrt(ci.freq)
    for gap in (1 / 15, 0.25, 0.5):
        ts = np.arange(0.0, 20.0 + 1e-9, gap)
        stream = corridor_imu_stream(ts, ci.noise_gyro, ci.noise_acc, ci.freq,
                                     (0.002, -0.001, 0.0015), (0.02, -0.01, 0.015), seed=0)
        conds, err_j, err_t, spread = [], [], [], []
        for g, a, d in stream[1:]:
            pj = jimu.integrate(jimu.empty_preintegrated(), jnp.asarray(g), jnp.asarray(a),
                                jnp.asarray(d), jnp.ones(len(d), bool), jnp.float32(sg),
                                jnp.float32(sa), jnp.float32(ci.walk_gyro),
                                jnp.float32(ci.walk_acc))
            pt = timu.integrate(timu.empty_preintegrated(), g, a, d, sg, sa, ci.walk_gyro,
                                ci.walk_acc)
            cov = np.asarray(pj.cov, np.float64) + 1e-8 * np.eye(9)
            conds.append(np.linalg.cond(cov))
            d_ = np.abs(np.diag(cov))
            spread.append((d_.min(), d_.max()))
            L64 = np.linalg.cholesky(np.linalg.inv(cov))
            Lj = np.asarray(jnp.linalg.cholesky(jnp.linalg.inv(pj.cov + 1e-8 * jnp.eye(9))))
            Lt = sqrt_info(pt.cov, 1e-8).numpy()
            scale = np.abs(L64).max()
            err_j.append(np.abs(Lj - L64).max() / scale)
            err_t.append(np.abs(Lt - L64).max() / scale)
        sp = np.asarray(spread)
        print(f"gap {gap:.4f} s ({len(conds)} gaps): cond(cov + 1e-8 I) median "
              f"{np.median(conds):.3e}, max {np.max(conds):.3e}; diagonal {sp[:, 0].min():.2e}"
              f" .. {sp[:, 1].max():.2e}; f32 whitening vs f64, largest relative entry "
              f"error: reference {np.max(err_j):.2e}, port {np.max(err_t):.2e}; any NaN: "
              f"{bool(np.isnan(err_j).any() or np.isnan(err_t).any())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
