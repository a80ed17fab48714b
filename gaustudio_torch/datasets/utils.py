"""cameras.json interop (port of gaustudio_tpu/datasets/utils.py:287-338).

The COLMAP readers come in a later slice.
"""

from __future__ import annotations

import numpy as np

from gaustudio_torch.cameras import Camera, focal2fov, fov2focal


def JSON_to_camera(camera_json, device="cpu") -> Camera:
    """One entry of a 3DGS ``cameras.json`` -> Camera.

    ``rotation`` and ``position`` are the camera-to-world rotation and the
    camera centre.
    """
    width = camera_json["width"]
    height = camera_json["height"]
    C2W = np.eye(4)
    C2W[:3, :3] = np.array(camera_json["rotation"])
    C2W[:3, 3] = np.array(camera_json["position"])
    Rt = np.linalg.inv(C2W)
    kwargs = {}
    if "cx" in camera_json and "cy" in camera_json:
        kwargs["principal_point_ndc"] = (
            camera_json["cx"] / width,
            camera_json["cy"] / height,
        )
    return Camera(
        image_name=camera_json["img_name"],
        image_width=width,
        image_height=height,
        R=Rt[:3, :3].transpose(),
        T=Rt[:3, 3],
        FoVx=focal2fov(camera_json["fx"], width),
        FoVy=focal2fov(camera_json["fy"], height),
        device=device,
        **kwargs,
    )


def camera_to_JSON(id, camera: Camera) -> dict:
    """Camera -> one entry of a 3DGS ``cameras.json``."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(camera.R).transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    return {
        "id": id,
        "img_name": camera.image_name,
        "width": int(camera.image_width),
        "height": int(camera.image_height),
        "position": C2W[:3, 3].tolist(),
        "rotation": [x.tolist() for x in C2W[:3, :3]],
        "fy": fov2focal(camera.FoVy, camera.image_height),
        "fx": fov2focal(camera.FoVx, camera.image_width),
        "cy": camera.image_height * camera.principal_point_ndc[1],
        "cx": camera.image_width * camera.principal_point_ndc[0],
    }
