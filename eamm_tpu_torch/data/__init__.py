"""Host-side input preparation (numpy and scipy): face crop and alignment
for the demo (``preprocess``, ``landmarks``), augmentation
(``augmentation``), the AVI writers (``native``), and the training and
evaluation datasets (LRW, Vox, MEAD, pairs), repeater and loader
(``datasets``) over PNG or packed frames (``packed``), the PNGs decoded
by ``native.decode_batch`` (the native libpng library, else imageio, else
the standard library's zlib)."""
