"""Route modules of the port's server: camera, face and alerts, path for path
as in ``frp_tpu/api/routes``."""
