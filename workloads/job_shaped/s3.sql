-- Synthetic JOB-shaped query s3, modelled on JOB family 3 (Leis et al.,
-- VLDB 2015): keyword LIKE and an IN list over movie_info. Written for
-- this repository; not a JOB query.
SELECT MIN(t.title) AS movie_title
FROM keyword AS k,
     movie_info AS mi,
     movie_keyword AS mk,
     title AS t
WHERE k.keyword LIKE '%remake%'
  AND mi.info IN ('Italy', 'Spain', 'Portugal', 'Greece', 'Italian', 'Spanish')
  AND t.production_year > 1995
  AND t.id = mi.movie_id
  AND t.id = mk.movie_id
  AND mk.movie_id = mi.movie_id
  AND k.id = mk.keyword_id;
