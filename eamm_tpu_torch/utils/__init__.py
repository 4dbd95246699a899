"""Host-side helpers of the port, and the evaluation metrics
(``metrics``)."""
