from .sensor_contact import SensorContact
from .sensor_frame_transform import SensorFrameTransform
from .sensor_imu import SensorIMU

__all__ = ["SensorContact", "SensorFrameTransform", "SensorIMU"]
