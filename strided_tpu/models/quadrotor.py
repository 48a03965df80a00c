"""Quadrotor, 12-state: the flagship MPC model (BASELINE.json north star —
"quadrotor 12-state condensed-QP MPC, horizon 50").

State ``[p(3), v(3), eul(3)=phi,theta,psi, omega(3)]`` in world/body frames,
input ``[thrust, tau_x, tau_y, tau_z]``. Small-angle-safe Euler kinematics;
hover equilibrium at ``u_hover = [m*g, 0, 0, 0]``. ``hover_linearization``
returns the discrete (A, B) used by the condensed-QP MPC.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Model

__all__ = ["quadrotor", "hover_state", "hover_input"]


def quadrotor(
    m=1.0,
    g=9.81,
    Jx=0.01,
    Jy=0.01,
    Jz=0.02,
) -> Model:
    def dynamics(x, u):
        # dtype-faithful constants: the f32 device path must not silently
        # promote to f64 (SURVEY.md §7 precision story)
        J = jnp.array([Jx, Jy, Jz], x.dtype)
        v = x[..., 3:6]
        phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
        w = x[..., 9:12]
        thrust = u[..., 0]
        tau = u[..., 1:4]

        cphi, sphi = jnp.cos(phi), jnp.sin(phi)
        cth, sth = jnp.cos(th), jnp.sin(th)
        cpsi, spsi = jnp.cos(psi), jnp.sin(psi)

        # Body-z axis in world frame (ZYX Euler):
        zb = jnp.stack(
            [
                cpsi * sth * cphi + spsi * sphi,
                spsi * sth * cphi - cpsi * sphi,
                cth * cphi,
            ],
            axis=-1,
        )
        acc = zb * (thrust / m)[..., None] - jnp.array([0.0, 0.0, g], x.dtype)

        # Euler-angle kinematics (ZYX): eul_dot = E(eul) @ omega
        tth = jnp.tan(th)
        p_, q_, r_ = w[..., 0], w[..., 1], w[..., 2]
        phid = p_ + sphi * tth * q_ + cphi * tth * r_
        thd = cphi * q_ - sphi * r_
        psid = (sphi * q_ + cphi * r_) / jnp.maximum(cth, 1e-6)
        euld = jnp.stack([phid, thd, psid], axis=-1)

        # Rigid-body rotation: J w_dot = tau - w x (J w)
        Jw = J * w
        wdot = (tau - jnp.cross(w, Jw)) / J

        return jnp.concatenate([v, acc, euld, wdot], axis=-1)

    return Model("quadrotor", 12, 4, dynamics)


def hover_state(dtype=jnp.float32):
    return jnp.zeros(12, dtype)


def hover_input(m=1.0, g=9.81, dtype=jnp.float32):
    return jnp.array([m * g, 0.0, 0.0, 0.0], dtype)
