"""Token-scheduler defaults, with the values of ``kubeshare_tpu.constants``
(Gemini parity: ``-q 300 -m 20 -w 10000``)."""

#: sliding accounting window of the token scheduler, in milliseconds
WINDOW_MS = 10000.0
#: quota a grant carries when the client has that much allowance left
BASE_QUOTA_MS = 300.0
#: smallest quota worth granting; below it a client waits for its window
MIN_QUOTA_MS = 20.0
