"""Entry points of the port: the eager serving steps, the serve CLI
(``serve``) and the paper's Table II / Fig. 1(b) (``paper``)."""
