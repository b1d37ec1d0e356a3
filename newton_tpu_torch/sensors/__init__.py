from .sensor_contact import SensorContact
from .sensor_frame_transform import SensorFrameTransform
from .sensor_imu import SensorIMU
from .sensor_tiled_camera import SensorTiledCamera

__all__ = ["SensorContact", "SensorFrameTransform", "SensorIMU",
           "SensorTiledCamera"]
