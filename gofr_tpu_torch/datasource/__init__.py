"""The port's datasource clients. Only the Redis client the kv-cache's
shared tier (T2) builds is ported; the App's datasource rows
(``REDIS_HOST`` as a datasource, SQL, pub/sub) come with ROADMAP queue 1
item 13."""
