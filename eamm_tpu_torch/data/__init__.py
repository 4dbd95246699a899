"""Host-side input preparation (numpy and scipy): face crop and alignment
for the demo (``preprocess``, ``landmarks``), augmentation
(``augmentation``), the AVI writers (``native``), and part1 training's
LRW dataset, repeater and loader (``datasets``) over PNG or packed frames
(``packed``).  The part2 datasets and the native PNG batch decoder are not
ported yet."""
