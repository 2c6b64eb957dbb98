from repro_torch.distributed.meshinfo import DeviceMesh, MeshInfo, single_device_meshinfo

__all__ = ["DeviceMesh", "MeshInfo", "single_device_meshinfo"]
