"""The instance-segmentation head (``models.segmentation``), its trainer
(``models.train_seghead``) and its data- and tensor-parallel forms
(``models.parallel``)."""
