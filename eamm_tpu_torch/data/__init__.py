"""Host-side input preparation for the demo (numpy and scipy): face crop
and alignment (``preprocess``, ``landmarks``), the emotion clip's
augmentation (``augmentation``) and the AVI writers (``native``).  The
training datasets and the PNG batch decoder are not ported."""
