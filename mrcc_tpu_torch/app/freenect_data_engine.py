"""Live ROS / Kinect data engine (port of
``mrcc_tpu/app/freenect_data_engine.py``, after the reference's
``app/freenect_data_engine.py``): subscribes to the registered cloud and
the EE pose topics, throttles to ``fps`` and hands ``PointCloudDTO``s to
the app through a queue of one that drops frames while full.

ROS is optional: the constructor raises a clear ``RuntimeError`` where
``rospy`` cannot be imported, and ``run`` imports ``rospy`` and the
message types."""

from __future__ import annotations

import datetime
import queue
import threading
import time

import numpy as np

from .data_engine import DataEngineInterface
from .dto import PointCloudDTO


class FreenectDataEngine(DataEngineInterface):
    def __init__(self, fps: float = 2.0,
                 cloud_topic: str = "/camera/depth_registered/points",
                 pose_topic: str = "/robot/ee_pose"):
        try:
            import rospy  # noqa: F401
            import sensor_msgs.msg  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "FreenectDataEngine needs a ROS environment (rospy); use "
                "PickleDataEngine or SyntheticDataEngine instead.") from e
        self.fps = fps
        self.cloud_topic = cloud_topic
        self.pose_topic = pose_topic
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._pose = None
        self._stop = threading.Event()

    def _on_pose(self, msg):
        """A ``PoseStamped``: position and the XYZW orientation as a WXYZ
        7-vector pose (the quaternion through float32, as JAX's)."""
        p, o = msg.pose.position, msg.pose.orientation
        self._pose = np.concatenate([[p.x, p.y, p.z], np.array(
            [o.w, o.x, o.y, o.z], np.float32)])

    def _on_cloud(self, points, rgb):
        dto = PointCloudDTO(points=points, rgb=rgb,
                            timestamp=datetime.datetime.now(
                                datetime.timezone.utc),
                            ee2base_pose=self._pose)
        try:
            self._queue.put_nowait(dto)
        except queue.Full:  # the app is busy: drop the frame
            pass

    def get(self):
        try:
            return self._queue.get(timeout=5.0)
        except queue.Empty:
            return None

    def run(self):
        import rospy
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import PointCloud2

        from ..utils.ros_utils import pointcloud2_to_arrays

        rospy.init_node("mrcc_tpu_freenect", anonymous=True)
        rospy.Subscriber(self.pose_topic, PoseStamped, self._on_pose)
        period = 1.0 / self.fps
        last = [0.0]

        def on_cloud(msg):
            now = time.time()
            if now - last[0] < period:
                return
            last[0] = now
            self._on_cloud(*pointcloud2_to_arrays(msg))

        rospy.Subscriber(self.cloud_topic, PointCloud2, on_cloud)

    def exit(self):
        self._stop.set()
