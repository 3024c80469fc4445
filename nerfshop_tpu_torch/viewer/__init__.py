from nerfshop_tpu_torch.viewer.server import ViewerServer, serve  # noqa: F401
