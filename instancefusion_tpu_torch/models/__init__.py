"""The instance-segmentation head (``models.segmentation``)."""
