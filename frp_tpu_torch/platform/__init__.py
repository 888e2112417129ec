"""Host-side services of the port's platform (copies of ``frp_tpu/platform``'s
camera registry, face service, tracking, alerts and health checks), built
around the port's ``RecognitionEngine``."""
