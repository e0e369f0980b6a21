-- Synthetic JOB-shaped query s32, modelled on JOB family 32 (Leis et al.,
-- VLDB 2015): title occurs twice, joined through movie_link. Written for
-- this repository; not a JOB query.
SELECT MIN(lt.link) AS link_type,
       MIN(t1.title) AS first_movie,
       MIN(t2.title) AS linked_movie
FROM keyword AS k,
     link_type AS lt,
     movie_keyword AS mk,
     movie_link AS ml,
     title AS t1,
     title AS t2
WHERE k.keyword = 'character-name-in-title'
  AND t2.production_year BETWEEN 1990 AND 2015
  AND mk.keyword_id = k.id
  AND t1.id = mk.movie_id
  AND ml.movie_id = t1.id
  AND ml.linked_movie_id = t2.id
  AND lt.id = ml.link_type_id
  AND mk.movie_id = t1.id;
