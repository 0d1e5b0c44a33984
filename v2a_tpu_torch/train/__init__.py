"""Training loops of the port: the video-model train step, the policy train
step and the online loop."""
