from hmd_ego_pose_tpu_torch.export.pt2 import export_inference, load_and_verify

__all__ = ["export_inference", "load_and_verify"]
