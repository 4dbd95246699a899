"""Host-side input preparation (numpy and scipy): face crop and alignment
for the demo (``preprocess``, ``landmarks``), augmentation
(``augmentation``), the AVI writers (``native``), and the training and
evaluation datasets (LRW, Vox, MEAD, pairs), repeater and loader
(``datasets``) over PNG or packed frames (``packed``).  The native PNG
batch decoder is not ported yet."""
